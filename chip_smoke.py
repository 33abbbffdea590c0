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
   the device's busy time per execute and idle share. Then the
   actor-loop backend (experimental_compile(backend="actor")) on the
   one-process runtime: a 4-stage actor pipeline (Plus(i), 10 executes)
   gives i + 10; a 2-stage pipeline hands back the very CUDA tensor it
   was given (out is x, on cuda:0); tests/test_dag.py's mixed DAG on
   CUDA tensors fuses its two device stages into one driver stage beside
   the fused tail (two driver stages), its actor sees a CUDA tensor and
   the values are right; a stage's ValueError reaches get; an allreduce
   of 4 actor ranks (ray_tpu_torch.collective.collective) gives their
   sum on the card. Readings: us per synchronous execute + get of the
   4-stage pipeline (p50) and per pipelined execute, beside the torch
   executor's chain_1k_noop p50.
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
   Then the runners as actors of the one-process runtime, each
   on a CUDA stream of its own: Algorithm (PPO) with num_env_runners=2,
   runner i's rollouts (twice) equal a local EnvRunner(seed=SEED + i)'s
   on the card, and two train() iterations give finite losses; IMPALA's
   asynchronous loop at tests/test_rl_async.py's settings (2 runners, 32
   envs x 64 steps, lr 4e-3, entropy 0.005) over 4 and then 60 updates:
   the reference test's limits, the last episode_len_mean above 1.5x the
   first and collection_update_overlap_s above 0. Readings: env steps/s
   and the update wall of both runs, beside twice one runner actor's
   rate alone (the runners' graphs overlap the learner on the card when
   the loop comes near it) and two runner actors sampling at once with
   no learner (whether the runners' graphs overlap each other).
13. serve: the one-process runtime and Serve (ray_tpu_torch.init,
   serve.run(build_llm_app(EngineConfig(model=TransformerConfig()))))
   serving the flagship at full width (bf16, weights from param_seed 0 in
   the replica). Phase 4's 8 prompts (16-1000 tokens, 32 new), one at a
   time through handle.options(stream=True) and through the HTTP proxy's
   ?stream=1: each stream equal, token for token, to the same engine
   config's own InferenceEngine.generate of the prompt; then all 8 at
   once on a fresh deployment, equal to those (phase 4's check). The GQA
   variant (n_kv_heads 4) on 2 prompts the same way. A 400-token stream
   closed after its first token frees its KV blocks (blocks_in_use and
   running reach 0 within a bounded poll). Two replicas warmed with a
   64-token system prompt: a request with that prefix is routed by
   prefix overlap to a replica whose prefix_cache_hits rises. A CUDA
   tensor's put/get and task round trips come back on cuda:0 with equal
   values. The flash counters are read over the served runs: the engine
   prefills and decodes through paged attention (plain PyTorch, as the
   reference's engine does in plain JAX), so no kernel of phases 1-2
   runs on the served path and every counter, plain_routes included,
   must stay 0. Smoke readings, no limits: TTFT and token gap p50
   through the handle and through HTTP beside the engine direct, us per
   trivial task and per actor call (batched and one at a time), and the
   CUDA put/get round trip beside the two device copies it makes.
   Then disaggregated serving of the flagship: one prefill and
   one decode replica on cuda:0 (build_disagg_llm_app, serve.run of both
   apps, DisaggHandle.from_deployments()). The 8 prompts through
   DisaggHandle.stream equal the engine's generate, paired 8 and
   prefill_fallbacks 0; a prompt sharing the 570-token prompt's blocks
   through stream_planned ships fewer blocks than it holds and streams
   equal too; the publish/ack ledger balances (kv_acks == kv_publishes,
   nothing outstanding, the prefill pool's blocks_in_use 0 within a
   bounded poll); a dead ticket falls back to a local re-prefill with
   equal tokens; every flash counter stays 0 over all of it. Readings:
   TTFT and token gap p50 through DisaggHandle beside the colocated
   handle's, transfer_p50_s of the decode pool's TTFT decomposition, KV
   bytes per prompt.
14. trainer: Train's worker-group trainer on the one-process runtime
   (ray_tpu_torch.train), the flagship at full width (bf16 compute over
   f32 masters, 4 x 2048 tokens a step) fed by a Dataset
   (data.from_columns of a seeded [64, 2049] int64 token array,
   parallelism 4; iter_torch_batches onto the card). (a) A
   DataParallelTrainer with one worker, a checkpoint (parameters, AdamW
   state, step) every 4 of 12 steps to memory://smoke14 (num_to_keep 2,
   async_save): its 12 losses equal, bit for bit, make_train_step called
   directly on the same batches from the same seed; the forward, dQ and
   dK/dV launch 4 / 4 / 4 times a step on the tensor cores in both, no
   plain route; 2 checkpoints stored. (d) The step-12 checkpoint (about
   545 MB) through Checkpoint.to_uri and from_uri over memory:// and a
   file:// directory: every leaf back bit for bit; s3:// raises
   ValueError; CheckpointStore.persist and persist_async (wait raises an
   upload error) timed. (b) The same run with FailureConfig(max_failures=
   1) and a failure planted before step 9 of the first attempt: the group
   restarts from the step-8 checkpoint and steps 9-12 equal (a)'s bit for
   bit; with max_failures=0 the run raises TrainingFailedError. (c)
   DataParallelTrainer.restore("memory://smoke14/a") (configs from its
   trainer.pkl) runs 4 more steps equal to steps 13-16 of the direct
   loop, bit for bit; the store then holds at most 2 checkpoints. (e) A
   TorchTrainer with 2 workers on the card: an MLP at the flagship's
   widths (512 -> 1376 -> 512, f32) under prepare_model, each rank on its
   half of 4096 rows from Dataset.split, 10 AdamW steps: the ranks'
   parameters bit-equal, within TRAINER_MLP_TOL of one worker on the
   whole batch, the loss falling. Smoke readings (no limits): step time
   p50 through the trainer beside the direct loop, iter_torch_batches
   seconds a batch, checkpoint save, persist and persist_async seconds,
   upload and download seconds over memory:// and file://, restart
   seconds, the two-rank step time and the allreduce's share of it. Every
   temporary checkpoint directory is removed at the end.
15. observe: the tracing plane, the task events and the flight recorder
   (ray_tpu_torch._private.tracing, task_events, flight; util.state,
   util.metrics). (a) With RAY_TPU_TRACE and RAY_TPU_FLIGHT unset: a
   task, an actor call and phase 13's 8 prompts served through the handle
   leave the tracer and the recorder off, zero spans, no _trace key in
   the request dicts the replica sees, the engine's tokens. (b) A fresh
   init() with both set: the 8 prompts through the handle, through the
   HTTP proxy and through a disaggregated prefill/decode pair, one at a
   time: every stream equals the engine's generate; each request is one
   trace of exactly the reference's spans (http.request for HTTP, then
   serve.request, the replica call's task.queue and task.exec, the
   engine's llm.queue, llm.prefill and llm.decode, and llm.kv_ship on the
   decode hop), each under serve.request, none of the engine's starting
   before it, one first_token event inside llm.decode, no error; the
   kv_ship tags equal the blocks and bytes export_blocks shipped. (c) The
   flagship's bf16 make_train_step as an actor method, 6 steps of 4 x 2048
   tokens inside the span smoke.train, steps 3-4 inside profile_trace
   ((a) runs them too, untraced): losses equal the direct call's bit for
   bit, 4 / 4 / 4 wgmma launches a
   step and no plain route, timeline() holds the 6 calls FINISHED and
   timeline(trace_id=...) their task.queue and task.exec under
   smoke.train. (d) debug_dump(): manifest.json and driver.json, whose
   sections hold runtime, serve and one llm.engine-<id> per engine built
   since arming, whose artifacts name (c)'s logdir, whose stacks name the
   actor's thread and whose metrics parse as Prometheus text with
   ray_tpu_trace_spans_recorded > 0. (e) A lock noted held past 0.2 s
   fires the lock-hold watchdog once and writes one auto dump. Smoke
   readings (no limits): TTFT and token gap p50 armed against (a)'s
   unarmed run, each span's p50 per request kind (host clock), the
   prefill hop's time outside its engine spans, us per trivial task
   armed and unarmed (one get at a time and 2000 at once) with the traced
   tasks' task.queue and task.exec p50, spans a request and a train step, the traced actor step's p50 against the unarmed actor's
   and the direct call's, the profiled steps' device time from the trace,
   debug_dump seconds and bundle bytes. The tracer and the recorder are
   off again at the end, and every temporary directory is removed.

16. data: Data's all-to-all operators, its file readers and writers,
   custom sources and sinks, and offline RL (ray_tpu_torch.data,
   ray_tpu_torch.rl.offline). (a) Phase 14's seeded [64, 2049] int64
   token table through write_tfrecords and read_tfrecords, through
   np.save and read_numpy, and one file through read_binary_files: every
   row back bit for bit; a record with one flipped payload byte raises
   under check_integrity=True. (b) The TFRecord dataset stacked into a
   [rows, 2049] column and random_shuffle(seed=24), fed to a
   DataParallelTrainer with one worker: the flagship at full width and
   depth, bf16 compute over f32 masters, 4 x 2048 tokens a step, 12
   steps. Two executions of the shuffled dataset give the same order, a
   permutation of the written rows; the worker takes the rows in that
   order; its losses equal make_train_step called directly on those rows,
   bit for bit; the forward, dQ and dK/dV launch 4 / 4 / 4 times a step
   on the tensor cores in both, no plain route. (c) A seeded table of
   4,194,304 rows (about 80 MB) in 32 blocks: random_shuffle is a
   permutation of the rows; sort("key") both ways equals the stable
   argsort order, row for row; groupby("bucket").aggregate(Count, Sum,
   Mean, Min, Max, Std) equals numpy within DATA_AGG_RTOL;
   repartition(7) keeps every row in 7 blocks; zip of two equal-length
   datasets lines the rows up, and unequal lengths raise ValueError. (d)
   An online DQN on CartPole at tests/test_rl_async.py's settings on the
   card; its buffer through buffer_to_dataset, write_tfrecords,
   read_tfrecords and train_dqn_offline (40 iterations, seed 7, on the
   card): the buffer comes back bit for bit, the offline learner's greedy
   return reaches 0.6 of the online one, and one offline iteration as a
   CUDA graph equals the same iteration run eagerly within RL_GRAPH_TOL.
   (e) A custom Datasource round-trips rows; a custom Datasink sees
   start, its writes and complete, and on a planted failure
   on_write_failed before the error re-raises. Smoke readings (no
   limits): write_tfrecords and read_tfrecords seconds and MB/s, (c)'s
   operators' seconds, the trainer's step p50 beside the direct loop's,
   offline DQN seconds an iteration, the phase's seconds. Every temporary
   directory is removed.

17. tune: Tune and durable workflows (ray_tpu_torch.tune,
   ray_tpu_torch.workflow), each driving the flagship's bf16 train step
   at full width and depth, 4 x 2048 tokens a step, on phase 14's token
   table. (a) A Tuner over TUNE_LRS under ASHA (max_t 8, grace 2,
   reduction factor 2), two trials at once on the card; each trial
   make_train_step at its learning rate from seed-0 parameters, one
   tune.report of the loss a step, a flat checkpoint (parameters, AdamW
   state, step) in the reports at a rung or at max_t. Every trial's
   losses equal make_train_step called directly at its learning rate,
   bit for bit, for the steps it ran; ASHA cut at least one trial; each
   trial's last report carries its checkpoint; get_best_result() names
   the lowest final loss; the best trial's checkpoint resumes one more
   step whose loss and parameters equal the direct run's, bit for bit;
   the forward, dQ and dK/dV launch 4 / 4 / 4 times a trial step on the
   tensor cores, no plain route. (b) A workflow: the token table, four
   segments of 3 steps (each commits the parameters and the AdamW state,
   on the card), the evaluation loss. A child driver (this file imported
   as the module chip_smoke), started while (a) runs, opens its CUDA
   context and runtime and waits for (b)'s go; it runs the workflow
   until segment 2 parks at its start and is killed with SIGKILL by
   the chaos plane (a seeded NodeKiller over popen_kill_target, started
   when the child parks, max_kills=1: chaos.snapshot() counts one kill
   and util.state.chaos_summary() shows it, with the child's pid); it
   built no kernel (the parent's are on disk). The parent resumes it,
   traced: the workflow was RUNNING with
   three steps committed; every step ran exactly once across the two
   processes (the side-effect log); the losses, the final parameters and
   the evaluation loss equal an uninterrupted run bit for bit; a
   committed CUDA tensor comes back on the card, as does the live value
   passed on; util.state.list_workflows() shows it SUCCESS; one
   workflow.step span per step run here; 4 / 4 / 4 launches a segment
   step (and 4 forward for the evaluation), no second build. Smoke
   readings: trial wall seconds, step ms with one trial and with two at
   once beside the direct loop, report-to-ack ms p50 / p99, launches per
   trial step; commit seconds and bytes per segment, resume seconds,
   launches per segment step, the child's seconds to ready and from go
   to the hold. Every temporary directory is removed.

18. util: util's placement groups, the sanitizer and loadgen, and
   Serve's batch, on the flagship at full width and depth (bf16). (a)
   placement_group([{"CPU": 1}], "PACK") is ready; available_resources()
   shows the reservation and list_placement_groups() shows it CREATED;
   an actor created with PlacementGroupSchedulingStrategy(pg, 0) runs 4
   train steps of 4 x 2048 tokens, whose losses equal make_train_step
   called directly, bit for bit, with the forward, dQ and dK/dV launched
   4 / 4 / 4 times a step on the tensor cores and no plain route;
   STRICT_SPREAD over two bundles raises ValueError; removing the group
   gives the CPU back. (b) A @serve.batch deployment (max 4, 50 ms wait)
   pads each batch to a fixed [4, 512] and runs forward under no_grad; 16
   concurrent requests through the handle (prompts of 8-512 tokens) come
   back in batches of which one holds more than one request; each
   request's greedy token equals a direct forward of the same fixed
   shape with the prompt in the same row, and its last-position logits
   are within UTIL_BATCH_LOGIT_TOL of it; 4 forward launches a batch on
   the tensor cores. (c) The sanitizer armed before init (the runtime
   starts its stall watchdog), phase 13's LLMServer through the handle,
   driven by a seeded loadgen episode Ramp(2, 16, 2 s) >> Spike(32, 1 s)
   >> Ramp(16, 2, 2 s) over 8 prompts, 16 new tokens each: every request
   is ok and its tokens equal the engine's own generate of its prompt;
   the same seed replays the same schedule; no flash kernel launched;
   sanitizer.violations() is empty; shutdown joined the watchdog and the
   generator's threads ended. Smoke readings: (a)'s step p50 beside the
   direct loop's; (b)'s batch sizes and logit error; (c)'s summary (p50 /
   p99 latency, max_lag_s) and TTFT p50 over 8 sequential requests with
   the sanitizer armed and unarmed.

19. process: the process plane (init(worker_mode="process",
   num_cpus=4)) beside the card, at the flagship's full width and depth
   (bf16). /dev/shm's free bytes are printed (and must hold the shm
   store). (a) A task, and one asking num_gpus=1, run in another pid
   with CUDA_VISIBLE_DEVICES="" and torch.cuda.is_available() False; the
   driver's resources still show the card. (b) A Dataset's map_batches
   stage builds token batches in worker processes (the stage's pids are
   the pool's, not the driver's) and feeds PROC_TRAIN_STEPS bf16 train
   steps on the card in the driver through iter_torch_batches onto
   cuda:0; the losses equal the same pipeline and steps on the thread
   plane bit for bit, with the forward, dQ and dK/dV launched 4 / 4 / 4
   times a step on the tensor cores and no plain route. (c) A CUDA
   tensor as an argument, and a driver put of one passed by ref, arrive
   in the worker as CPU tensors with equal values (the driver's own get
   keeps the card); a 64 MiB return rides the shm store back equal. (d)
   A worker SIGKILLed in the middle of one of (b)'s map tasks: with
   retries the losses still equal the thread plane's; a SIGKILLed
   process-backed actor answers ActorDiedError while the driver's step
   and the card go on; an actor created with runtime="driver" builds the
   flagship on cuda:0 and takes the same step. (e) A worker's print
   reaches the session's log files and the driver's stderr through the
   log monitor. After shutdown every worker process has exited and the
   segment is unlinked. Smoke readings: worker boot (spawn to first
   reply) p50, a trivial task's round trip p50 on each plane, shm put and
   get of 64 MiB in GB/s, and (b)'s step p10 / p50 / p90 over the
   PROC_TRAIN_STEPS - 1 steps after the first, beside the thread-fed
   step's.

20. cluster: the cluster's control plane, at the flagship's full width
   and depth (bf16, 4 x 2048 tokens a step). A port head starts
   (python -m ray_tpu_torch._private.head_service --port 0 --state
   <tmp>); this driver attaches on the process plane with tracing and
   the flight recorder armed, and hosts the named actor
   "flagship_trainer" (runtime="driver": make_train_step on cuda:0). (a)
   A peer driver (a subprocess with CUDA_VISIBLE_DEVICES="") attaches to
   the same head, puts and announces CLUSTER_STEPS seeded token batches
   (CPU tensors) and calls get_actor("flagship_trainer").step.remote(ref)
   for each; the actor pulls each batch through the head. Its losses
   equal a direct loop in this driver on the same batches bit for bit,
   with the forward, dQ and dK/dV launched 4 / 4 / 4 times a step on the
   tensor cores and no plain route; the peer never initialised CUDA. (b)
   The actor publishes each step's loss on a topic the peer subscribed
   to: the peer receives all CLUSTER_STEPS, in order. (c) The peer is
   SIGKILLed: within the head's client timeout its client leaves
   cluster_info, and the trainer still answers this driver; then the
   head is SIGKILLed and restarted on the same port and --state: this
   driver's client reconnects, the head resolves "flagship_trainer" to
   it again, and a further step relayed through the head equals the
   direct loop's step CLUSTER_STEPS + 1. (d) A compiled DAG of two
   process-backed actor stages on the shm plane (a seeded draw, then the
   shift into inputs and labels) builds CLUSTER_DAG_STEPS batches that
   this driver feeds to a fresh step: the losses equal the direct loop's;
   a traced task's worker.exec span (in a worker process) appears in
   timeline(trace_id), and the worker processes' flight bundles in
   debug_dump(). Smoke readings: head boot s; the relayed trivial call's
   round trip p50 / p99 (at the peer); the step p50 through the relay
   (at the peer and in the actor) beside the direct loop's; a 64 MiB
   object pulled from the peer in GB/s; the head's restart and the
   client's reconnect in s.

21. nodes: the node plane, at the flagship's full width and depth (bf16,
   4 x 2048 tokens a step). A port head and five node daemons start at
   once (python -m ray_tpu_torch._private.node_daemon): card nodes A and
   B (--worker-mode thread, {"card_a": 1} / {"card_b": 1}; each sees the
   card and advertises GPU 1), feed nodes F1 and F2 (--worker-mode
   process, {"feed": 1}, CUDA_VISIBLE_DEVICES="") and T (thread, no card,
   launched under RAY_TPU_TRACE_PARENT); each must print its joined line
   within NODE_JOIN_S. This driver attaches with num_cpus=0, num_gpus=0
   and keeps the card only for the direct loop (the oracle). (a) The
   named actor "flagship_node_trainer" (num_gpus=1, max_restarts=1) is
   placed by the router on a card node and steps NODE_STEPS batches,
   each made by a seeded feed task (resources {"feed": 1}) whose ref goes
   straight into trainer.step.remote(ref): the card node pulls it from
   the feed node peer to peer. Its losses equal the direct loop's bit for
   bit, with the forward, dQ and dK/dV launched 4 / 4 / 4 times a step on
   the tensor cores inside the daemon's process (counted there and
   returned by the actor) and no plain route; the feed tasks ran in F1's
   and F2's workers; no push was relayed by the head after the first
   wave. (b) A thin client (a subprocess with CUDA_VISIBLE_DEVICES="",
   init(address="ray://H:P")) resolves the actor by name and steps
   NODE_PEER_STEPS more batches that its own feed tasks make (refs it
   owns, resolved by the card node through it): steps 25-32 equal the
   direct loop's, the client has no CPU and never initialised CUDA. (c)
   F1 is SIGKILLed under a wave of NODE_WAVE feed tasks: every batch
   arrives (rerouted to F2 or re-executed from lineage) and the next step
   equals the direct loop's; then the card node hosting the trainer is
   SIGKILLed: the call in flight fails with ActorDiedError, the actor
   restarts with fresh state on the other card node, and its first
   NODE_RESTART_STEPS steps equal the direct loop's first ones. (d)
   Tracing and the flight recorder are armed: a traced feed and step
   bring the feed node's and the card node's spans into this driver's
   timeline(trace_id); debug_dump() holds a bundle and cluster_metrics()
   the registry of every live daemon; T's node.init span is in the trace
   its RAY_TPU_TRACE_PARENT named. Smoke readings: daemon boot (spawn to
   the joined line), a trivial task's round trip p50 / p99, the step p50
   through the placed actor and from the thin client beside the direct
   loop's, a 64 MiB object pulled from F1 to the card node in GB/s, and
   the seconds from each kill to the rerouted wave and to the restarted
   actor's first step.

22. elastic: the cluster's operator surface, at the flagship's full
   width and depth (bf16, 4 x 2048 tokens a step). A port head starts
   through the port's CLI (python -m ray_tpu_torch.scripts.cli start
   --head --port 0 --metrics-port 0); this driver attaches with no CPU
   and no GPU and runs a ClusterAutoscaler (node types "card" {"CPU": 2,
   "GPU": 1}, max 1, and "feed" {"CPU": 2, "feed": 1}, max 2, both min
   0, launched by LocalSubprocessProvider on the thread plane, the feed
   type with the card hidden; idle timeout ELASTIC_IDLE_S) and the
   dashboard. At the start the head is the only member. (a)
   JobSubmissionClient submits the job driver chip_smoke_job.py (which
   imports no torch, so it makes its demand within a second of its
   start) with a runtime_env (env_vars, working_dir): it attaches with no CPU
   and no GPU and creates the named actor "flagship_elastic_trainer"
   (num_gpus=1); its ELASTIC_STEPS feed tasks (resources {"feed": 1},
   env var FEED_TAG under a runtime_env), submitted at once, make seeded
   batches whose refs go straight into trainer.step.remote(ref). No node
   can place any of them, so the autoscaler launches both types in one
   update (the feed type up to its cap of 2: one node a task's shape);
   the direct loop runs here meanwhile. The feed nodes go idle once the
   batches are made and may be reaped before the job ends. The job SUCCEEDS, its losses equal the direct
   loop's bit for bit, the forward, dQ and dK/dV launch 4 / 4 / 4 times a
   step on the tensor cores in the launched card daemon's process with
   no plain route, every feed task saw its tag and ran in a feed daemon,
   the card node advertises GPU 1 and no feed node any,
   autoscaler_summary() shows one card launch, at least one feed launch,
   no failure and the join latencies, and the dashboard's /api/elastic
   and /api/snapshot agree with it. (b) Both types go idle and are
   drained and reaped (no untransferred object) until the head is the
   only member again; a second job (ELASTIC_STEPS_2 steps, fresh seed-0
   weights) launches both again and its losses equal the direct loop's
   first ones. (c) While its nodes live: the CLI's debug --address
   archives a bundle of every live daemon and the head's, the
   dashboard's /metrics and the head's --metrics-port scrape hold every
   live daemon's registry, and the CLI's job submit runs a command and
   prints its log. Smoke readings (host clock): each job's submit to its
   first step, each type's launch (spawn to the joined line) in each job,
   the trainer's creation (the parameters on the card, make_train_step),
   the job's step p50 beside the direct loop's, and idle to reaped.

23. distributed: the multi-process device plane (ray_tpu_torch.parallel.
   distributed), the flagship at full width and depth (bf16,
   DIST_BATCH x DIST_LEN = 4 x 2048 global tokens a step). (a) One
   process: initialize() with no coordinator is a no-op (one process,
   index 0, the whole batch), and a sum over each tier of
   make_hybrid_mesh(dcn dp 2, ici tp 2) over 4 virtual shards of the card
   gives every shard the total, exactly. (b) Two processes on this one
   card (torch_distributed_worker.py) join over gloo, which a line names
   (NCCL refuses two ranks on one device), their address, size and rank
   from the RAY_TPU_* environment variables; each builds
   make_spmd_train_step on make_mesh(dp=2), whose dp crosses them, and
   takes DIST_STEPS steps of the default AdamW, then DIST_SGD_STEPS of
   SGD from fresh weights, on its own rows (host_local_batch_slice) of
   each global batch. Their losses and every leaf of their shards equal,
   to DIST_LOSS_TOL and DIST_UPDATE_TOL, the one-process dp-2 mesh over 2
   virtual shards of the card on the whole batches; each process launches
   the forward, dQ and dK/dV n_layers times a step on the tensor cores
   (counted in it, zeroed just before its steps) and imports neither JAX
   nor ray_tpu. Smoke reading: the step p50 on the host clock, beside the
   one-process mesh's. (c) Where at least two cards are visible, NCCL
   with a process per card: the same two jobs (DIST_NCCL_STEPS of AdamW),
   every loss held to DIST_LOSS_TOL and every leaf to DIST_UPDATE_TOL
   against one process over every card (peer copies), the same launch
   and import checks; the flagship's step p50 on one card, in one process
   over every card and in a process per card over NCCL, and the
   all-reduce of the 181.7 MB f32 gradient alone (p50 and bus GB/s); with
   one card a line says (c) did not run. (d) pp across processes: two
   processes on this one card over gloo (a line names it and says that a
   hop across them goes through host memory), make_mesh(pp=2), a stage
   of n_layers / 2 layers in each, both feeding the whole batch
   (host_local_batch_slice(..., mesh=mesh)); DIST_STEPS of the default
   AdamW, then DIST_SGD_STEPS of SGD from fresh weights. Their losses and
   every leaf of their shards equal the one-process pp-2 mesh over 2
   virtual shards of the card to DIST_LOSS_TOL and DIST_UPDATE_TOL; each
   process launches the forward, dQ and dK/dV on the tensor cores as its
   stage's shard does there (n_layers / 2 layers x DIST_MICROBATCHES
   a step), counted in it, and imports neither JAX nor ray_tpu. (e)
   Where at least four cards are visible, NCCL with a process per card:
   make_mesh(dp=2, pp=2) over four (dp and pp both across processes) and
   make_mesh(pp=2) over two of the cards, each held against one process
   over the same cards (peer copies) with the same checks; with fewer
   cards a line says (e) did not run. (f) tp across processes: two
   processes on this one card over gloo (a line names it and says that
   an all-reduce across them goes through host memory), make_mesh(tp=2),
   the flagship's n_heads / 2 heads in each, both feeding the whole
   batch; DIST_STEPS of the default AdamW, then DIST_SGD_STEPS of SGD
   from fresh weights. Their losses and every leaf of their shards equal
   the one-process tp-2 mesh over 2 virtual shards of the card to
   DIST_LOSS_TOL and DIST_UPDATE_TOL; each process launches the forward,
   dQ and dK/dV on the tensor cores n_layers times a step, counted in
   it, and imports neither JAX nor ray_tpu. Where at least four cards
   are visible, NCCL on the f32 flagship: make_mesh(tp=4) over four
   processes of a card each, and make_mesh(tp=2, sp=2) over two
   processes of two cards each (tp across them, sp inside each, ring
   attention's plain blocks, and autograd through the exchanges across
   processes from a process of two cards), each held against one
   process over the same cards with the same checks (the tiled f32
   kernels n_layers times a shard a step for tp4, none for tp2-sp2),
   except their AdamW leaves, of which at most DIST_REORDER_FRACTION may
   differ by more than DIST_UPDATE_TOL;
   with fewer cards a line says they did not run. Smoke readings (host
   clock): the step p50 of each layout beside the one-process mesh's,
   the seconds of one hop of a [2, 2048, d_model] bf16 activation across
   processes ((d), (e)) and of one all-reduce of such an activation
   across them ((f)), and the phase's seconds.

24. formats: Data's pandas, Arrow, fsspec and PIL surface and
   TransformersTrainer (ray_tpu_torch.data, ray_tpu_torch.train.
   huggingface). (a) Phase 14's seeded [64, 2049] int64 token table as a
   list column (one 1-D row an element) through write_parquet into
   FORMATS_PARTS hive partitions (part=0/, part=1/): read_parquet(root,
   columns=["tokens", "part"]) gives every row back bit for bit with the
   typed partition column; the same read through a map_batches stage
   with batch_format="pandas" that passes the rows through, then stacked,
   feeds a DataParallelTrainer with one worker: the flagship at full
   width and depth, bf16 compute over f32 masters, 4 x 2048 tokens a
   step, DATA_TRAIN_STEPS steps. The worker takes the rows in the table's
   order, its losses equal make_train_step called directly on those rows
   bit for bit, and the forward, dQ and dK/dV launch 4 / 4 / 4 times a
   step on the tensor cores in both, no plain route. (b) FORMATS_ROWS rows
   (int64, float64, string) through write_parquet / read_parquet,
   write_csv / read_csv and write_json / read_json on memory:// and on
   the fsspec scheme local:// (an fsspec filesystem): each equals its
   source; FORMATS_IMAGES PNGs written with PIL come back equal from
   read_images. (c) TransformersTrainer fine-tunes BERT-base
   (BertForSequenceClassification(BertConfig(num_labels=2)): 12 layers,
   hidden 768, 12 heads, vocab 30522; f32, weights from
   torch.manual_seed(BERT_SEED), transformers' own attention) on the
   reference test's separable toy task at BERT_BATCH x BERT_SEQ on the
   card: one worker for BERT_STEPS steps, whose first loss equals the
   direct loop's bit for bit, whose losses equal the direct loop of the
   same step on the same batches bit for bit where that loop repeats
   itself and within BERT_LOSS_RTOL where it does not (it runs twice: the
   library's f32 attention backward did not repeat bit for bit on the
   H100), and whose last loss is below its first; then two workers sharing
   the card for BERT_DP_STEPS steps: both finish, rank 0's losses are
   finite and its first equals a direct forward on its shard's first
   batch. Smoke readings (no limits): the parquet write and read in MB/s,
   each format's seconds, the flagship's step p50 beside the direct
   loop's, BERT's step p50, tokens/s and peak memory, the phase's
   seconds. Every temporary directory is removed. A missing pandas,
   pyarrow, fsspec, PIL or transformers fails the phase.

``--only formats`` runs phase 24 alone, ``--only distributed`` runs phase 23 alone, ``--only elastic`` phase 22,
``--only nodes`` phase 21,
``--only cluster`` phase 20, ``--only process`` phase 19,
``--only util`` phase 18,
``--only tune`` phase 17, ``--only
data`` phase 16, ``--only observe`` phase 15 and ``--only rl --armed``
phase 12 under the flight recorder and its stack sampler (kernels build
at first use).

The processes the script starts (heads, node daemons, workers, job
drivers) share their compiled bytecode under build/pycache, written even
where the environment sets PYTHONDONTWRITEBYTECODE: without a bytecode
cache every new process compiles torch's sources again, which makes a
node's cold start mostly compilation.

The last lines are the kernels table, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import pickle
import re
import shutil
import signal
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
# Phase 8's actor backend: pipeline depth, checked executes, timed
# executes, and the ranks of the actor-plane allreduce.
DAG_ACTOR_STAGES = 4
DAG_ACTOR_EXECS = 10
DAG_ACTOR_TIMED = 200
DAG_ACTOR_RANKS = 4
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
# Phase 12's runner actors, and IMPALA's asynchronous loop at
# tests/test_rl_async.py's settings (2 runners, 32 x 64, its config) and
# update counts.
RL_REMOTE_RUNNERS = 2
RL_IMPALA_LOOP = {"lr": 4e-3, "entropy_coef": 0.005}
RL_IMPALA_SHAPE = (32, 64)
RL_IMPALA_UPDATES = (4, 60)
# Phase 13 (serve): the KV pool of every served engine, the system prompt
# the two routing replicas are warmed with, the cancelled stream's
# length, the GQA prompts, and the runtime's timed calls.
SERVE_NUM_BLOCKS = 512
SERVE_WARM_PREFIX = 64
SERVE_CANCEL_TOKENS = 400
SERVE_GQA_PROMPTS = 2
SERVE_POLL_S = 30.0        # bound on each poll and get of the phase
SERVE_TASKS = 2000         # trivial tasks / actor calls, submitted at once
SERVE_SYNC_CALLS = 200     # the same, one get at a time
SERVE_TENSOR_SHAPE = (4096, 4096)   # f32, 64 MiB through the store
SERVE_TENSOR_ITERS = 10
# Phase 13's disaggregated case: the prompt whose blocks the
# planned request shares (ENGINE_LENS[4], 570 tokens) and its own tail.
SERVE_DISAGG_SHARED = 4
SERVE_DISAGG_TAIL = 40
# Phase 14 (trainer): the flagship through DataParallelTrainer on
# TRAIN_BATCH x TRAIN_LEN batches, a checkpoint (parameters, AdamW state,
# step) every TRAINER_CKPT_EVERY steps to TRAINER_ROOT, TRAINER_KEEP kept;
# the planted failure before step TRAINER_FAIL_AT of the first attempt;
# restore runs TRAINER_MORE steps past TRAINER_STEPS. The two-rank case:
# an MLP at the flagship's widths (d_model -> d_ff -> d_model), f32,
# TRAINER_MLP_ROWS rows split between the ranks, TRAINER_MLP_STEPS AdamW
# steps at TRAINER_MLP_LR. Against one worker on the whole batch the
# parameters differ only by the rounding of two half-batch gradient means
# against one full-batch mean (~1e-7 after AdamW's normalisation); a
# rank left unsynchronised would drift by about one step's lr (1e-3) per
# step, so TRAINER_MLP_TOL is a tenth of one step.
TRAINER_ROOT = "memory://smoke14"
TRAINER_STEPS, TRAINER_MORE = 12, 4
TRAINER_CKPT_EVERY, TRAINER_KEEP, TRAINER_FAIL_AT = 4, 2, 9
TRAINER_MLP_ROWS, TRAINER_MLP_STEPS, TRAINER_MLP_LR = 4096, 10, 1e-3
TRAINER_MLP_TOL = 1e-4
# Phase 15 (observe): OBSERVE_TRAIN_STEPS bf16 steps as actor calls, the
# OBSERVE_PROFILED ones (1-based) inside profile_trace; the planted lock
# held past OBSERVE_LOCK_S fires the lock-hold watchdog once; every poll
# for a span or a fire is bounded by OBSERVE_POLL_S.
OBSERVE_TRAIN_STEPS = 6
OBSERVE_PROFILED = (3, 4)
OBSERVE_LOCK_S = 0.2
OBSERVE_POLL_S = 10.0
OBSERVE_ENV = ("RAY_TPU_TRACE", "RAY_TPU_FLIGHT", "RAY_TPU_PROFILE")
# Phase 16 (data): DATA_TRAIN_STEPS flagship steps from phase 14's token
# table written as TFRecords and shuffled with DATA_SHUFFLE_SEED; the
# all-to-all operators over DATA_ROWS rows (about 80 MB: key int64 in
# [0, DATA_KEY_RANGE), bucket = key % DATA_BUCKETS, x float32) in
# DATA_BLOCKS blocks. Each group's aggregates sum its values in the
# table's order, as numpy does over the group's mask, so they agree
# exactly in practice; DATA_AGG_RTOL (the CPU twins' bound) allows for
# another pairwise grouping of the same sums. The offline DQN takes
# tests/test_rl_async.py's settings: 32 envs x 64 steps, 22 online
# iterations, 40 offline ones from seed 7, and the reference's criterion
# (greedy return offline at least DATA_DQN_PARITY of online).
DATA_TRAIN_STEPS = 12
DATA_SHUFFLE_SEED = 24
DATA_ROWS, DATA_BLOCKS, DATA_KEY_RANGE, DATA_BUCKETS = 4_194_304, 32, \
    1 << 20, 64
DATA_AGG_RTOL = 1e-12
DATA_REPARTITION = 7
DATA_DQN_ENVS = (32, 64)
DATA_DQN_TRAIN = {"train_steps_per_iter": 96, "batch_size": 128,
                  "lr": 2e-3, "target_update_freq": 150}
DATA_DQN_MIN_BUFFER = 256
DATA_DQN_ONLINE_ITERS, DATA_DQN_OFFLINE_ITERS, DATA_DQN_SEED = 22, 40, 7
DATA_DQN_PARITY = 0.6
DATA_CUSTOM_ROWS = 1000
# Phase 17 (tune): a grid of TUNE_LRS (largest first) under ASHA
# (max_t TUNE_MAX_T, grace TUNE_GRACE, reduction factor TUNE_RF), at most
# TUNE_CONCURRENT trials at once; each trial the flagship's bf16 steps
# from seed-0 parameters on phase 14's token table, one report a step. A
# trial can be cut only at a rung or end at max_t, so its reports there
# carry a checkpoint (parameters, AdamW state, step). The workflow: a
# token table, WF_SEGMENTS segments of WF_SEGMENT_STEPS steps each (one
# commit of parameters and AdamW state each), then an evaluation loss on
# the next batch. The child driver parks at the start of segment
# WF_HOLD_AT (0-based) and is killed there; it must reach the hold within
# WF_CHILD_S, and holds at most WF_HOLD_S.
TUNE_LRS = (3e-3, 1e-3, 3e-4, 1e-4)
TUNE_MAX_T, TUNE_GRACE, TUNE_RF, TUNE_CONCURRENT = 8, 2, 2, 2
WF_SEGMENTS, WF_SEGMENT_STEPS, WF_HOLD_AT, WF_LR = 4, 3, 2, 3e-4
WF_CHILD_S, WF_HOLD_S = 240.0, 300.0
WF_KILL_AFTER_S = 0.2
WF_ID = "smoke17"
# Phase 18 (util): (a) UTIL_TRAIN_STEPS bf16 flagship steps in an actor
# placed with a placement group's strategy; (b) UTIL_BATCH_PROMPTS
# concurrent requests to a @serve.batch deployment that pads each batch
# to a fixed [UTIL_BATCH_ROWS, UTIL_BATCH_LEN] and runs forward; each
# request's last-position logits within UTIL_BATCH_LOGIT_TOL of a direct
# forward of the same fixed shape (bf16: a few units in the last place at
# the logits' size), its greedy token equal; (c) a seeded loadgen episode
# of UTIL_LOADGEN_SHAPE (Ramp, Spike, Ramp phases) over the served
# flagship, UTIL_LOADGEN_PROMPTS distinct prompts of UTIL_LOADGEN_LENS
# tokens, UTIL_LOADGEN_TOKENS new tokens each, with the sanitizer armed;
# UTIL_TTFT_REQUESTS sequential requests give the TTFT armed and unarmed.
UTIL_TRAIN_STEPS = 4
UTIL_BATCH_ROWS, UTIL_BATCH_LEN, UTIL_BATCH_PROMPTS = 4, 512, 16
UTIL_BATCH_WAIT_S = 0.05
UTIL_BATCH_LOGIT_TOL = 0.05
UTIL_LOADGEN_SHAPE = ((2.0, 16.0, 2.0), (32.0, 1.0), (16.0, 2.0, 2.0))
UTIL_LOADGEN_SEED = 18
UTIL_LOADGEN_LENS = (16, 40, 64, 100, 150, 200, 260, 300)
UTIL_LOADGEN_PROMPTS = len(UTIL_LOADGEN_LENS)
UTIL_LOADGEN_TOKENS = 16
UTIL_TTFT_REQUESTS = 8
# Phase 19 (process): PROC_TRAIN_STEPS flagship steps fed by a Dataset
# whose map_batches stage runs in worker processes (one TRAIN_BATCH-row
# batch per map task; the first attempt of batch PROC_KILL_BATCH is
# SIGKILLed in (d)); the step times after the first (23) resolve the
# process-fed step against the thread-fed one. PROC_BOOTS worker boots,
# PROC_ROUND_TRIPS trivial tasks per plane, PROC_SHM_ITERS puts and gets
# of PROC_SHM_BYTES; every wait bounded by PROC_POLL_S.
PROC_TRAIN_STEPS, PROC_KILL_BATCH = 24, 1
PROC_BOOTS, PROC_ROUND_TRIPS = 5, 50
PROC_SHM_BYTES, PROC_SHM_ITERS = 64 << 20, 5
PROC_POLL_S = 60.0

# Phase 20 (cluster): CLUSTER_STEPS relayed flagship steps, one more
# after the head's restart, CLUSTER_DAG_STEPS fed by the shm DAG;
# CLUSTER_RELAY_CALLS trivial relayed calls for the round trip;
# CLUSTER_PULL_BYTES pulled across drivers; the head's client timeout
# (a dead peer's entries leave within it); every wait bounded by
# CLUSTER_POLL_S.
CLUSTER_STEPS, CLUSTER_DAG_STEPS = 24, 8
CLUSTER_RELAY_CALLS = 200
CLUSTER_PULL_BYTES = 64 << 20
CLUSTER_CLIENT_TIMEOUT_S = 3.0
CLUSTER_POLL_S = 60.0
CLUSTER_ACTOR = "flagship_trainer"
CLUSTER_TOPIC = "chip_smoke:losses"

# Phase 21 (nodes): NODE_STEPS steps through the placed trainer,
# NODE_PEER_STEPS more from the ray:// client, NODE_RESTART_STEPS after
# its restart; NODE_WAVE feed tasks in flight when feed node F1 dies;
# NODE_TRIPS trivial tasks for the round trip; NODE_PULL_BYTES pulled
# from F1 to the card node; each daemon's joined line within
# NODE_JOIN_S, every other wait within NODE_POLL_S; the head's client
# timeout (a dead node leaves the membership within it).
NODE_STEPS, NODE_PEER_STEPS, NODE_RESTART_STEPS = 24, 8, 4
NODE_WAVE = 8
NODE_TRIPS = 200
NODE_PULL_BYTES = 64 << 20
NODE_JOIN_S = 60.0
NODE_POLL_S = 60.0
NODE_CLIENT_TIMEOUT_S = 2.0
NODE_ACTOR = "flagship_node_trainer"
# Phase 22: ELASTIC_STEPS steps in the first submitted job and
# ELASTIC_STEPS_2 in the second; the autoscaler reaps a node idle for
# ELASTIC_IDLE_S, within ELASTIC_REAP_S more; every other wait within
# ELASTIC_POLL_S.
ELASTIC_STEPS, ELASTIC_STEPS_2 = 16, 8
ELASTIC_IDLE_S = 4.0
ELASTIC_REAP_S = 20.0
ELASTIC_POLL_S = 60.0
ELASTIC_ACTOR = "flagship_elastic_trainer"
# Phase 23: the flagship (bf16) over DIST_BATCH x DIST_LEN global tokens a
# step, in DIST_MICROBATCHES microbatches. Every run takes DIST_STEPS
# steps in (b), DIST_NCCL_STEPS in (c), of the default AdamW (the first
# step untimed), then DIST_SGD_STEPS of SGD(DIST_SGD_LR) from fresh
# weights: AdamW's update hardly changes when every gradient is scaled
# alike, SGD's scales with it, so a mis-scaled gradient sync shows in the
# SGD leaves. DIST_ALLREDUCE_ITERS timed all-reduces of the f32 gradient
# in (c); every wait within DIST_POLL_S. (b)'s two processes and the
# one-process dp-2 mesh run the same kernels on the same rows and sum the
# same two gradients (a + b either way), so every loss agrees to
# DIST_LOSS_TOL (relative) and every f32 leaf to DIST_UPDATE_TOL: a
# skipped sync moves a leaf by ~lr = 3e-4. (c)'s NCCL sums the n
# gradients in another order than one process's fold (a + b + c + d
# left to right): on four H100s its losses came within 1.8e-7 and its
# leaves within 3.7e-9 of one process's (PERF.md, PR 31), so they are
# held to the same DIST_LOSS_TOL and DIST_UPDATE_TOL, far below what a
# skipped or mis-scaled sync moves (a loss by 3e-4, a leaf by 1e-3).
# (d) and (e) hold pp across processes to the same tolerances: each
# stage's process runs the kernels of the one-process mesh's shard on the
# same rows, a hop carries the bf16 activation bit for bit, and the sums
# across processes (the output cotangents at the last stage, the pp sync
# of embed, final_norm and lm_head) add the same two terms. DIST_HOP_ITERS
# timed hops of one [DIST_MICROBATCH_ROWS, DIST_LEN, d_model] bf16
# activation across processes in (d) and (e). (f)'s two processes on the
# one card sum each row-parallel product of two tp shards across gloo,
# a + b either way, as the one-process tp-2 mesh does, so it is held to
# the same tolerances. On four cards (f) runs the f32 flagship: a bf16
# sum of four tp shards that NCCL orders otherwise than one process's
# fold differs by a bf16 rounding (~4e-3 relative), which no 1e-6 can
# hold, while in f32 the reordering stays at f32 rounding, as in (c).
# Unlike (c), whose gradient sync adds the gradients of distinct rows,
# tp4's forward sums four partial activations in another order (and one
# process over four cards adds its backward's four cotangents in the
# order the cards' autograd threads deliver them), and tp2-sp2's sync of
# the leaves replicated over tp and sp adds four partial gradients as
# (a + b) + (c + d) where one process adds ((a + b) + c) + d. Partial
# sums can cancel, so a few gradient elements near zero change by much
# of themselves; AdamW scales every element's step to about lr whatever
# its gradient's size, so those elements move by up to a few lr. Their
# losses and SGD leaves stay within DIST_LOSS_TOL and DIST_UPDATE_TOL,
# and their AdamW leaves are held to the share of elements beyond
# DIST_UPDATE_TOL: at most DIST_REORDER_FRACTION, where a missed,
# doubled or swapped sum moves most elements of a leaf.
# scripts/tp_reorder_rehearsal.py rehearses tp4 on the CPU (four gloo
# processes against one over four shards, 6 AdamW steps of lr 3e-4):
# d_model 256 x 4 layers, 1280 of 11.6M elements beyond 1e-6, the
# largest 7.6e-4; d_model 512 x 2 layers, 5361 of 39.9M, the largest
# 9.4e-4; losses within 4.4e-7, SGD leaves within 1.2e-7. On four H100s
# (PERF.md §6) tp4 read 22553 of 143.7M (largest 7.4e-4) and tp2-sp2
# 5220 of 156.4M (largest 2.6e-4), losses within 8.8e-8 and 0, SGD
# leaves within 1.2e-7. DIST_ALLREDUCE_ITERS timed all-reduces of one
# such bf16 activation in (f).
DIST_BATCH, DIST_LEN, DIST_MICROBATCHES = 4, 2048, 2
DIST_STEPS, DIST_NCCL_STEPS, DIST_ALLREDUCE_ITERS = 8, 6, 10
DIST_HOP_ITERS = 10
DIST_SGD_STEPS, DIST_SGD_LR = 2, 0.1
DIST_LOSS_TOL, DIST_UPDATE_TOL = 1e-6, 1e-6
DIST_REORDER_FRACTION = 1e-3
DIST_POLL_S = 300.0
# Phase 24 (formats): (a) phase 14's token table as parquet in
# FORMATS_PARTS hive partitions, DATA_TRAIN_STEPS flagship steps from it.
# (b) FORMATS_ROWS rows (a int64, b = a / 2 float64, exact in JSON's ten
# digits, s a string) through each format on each scheme;
# FORMATS_IMAGES PNGs of FORMATS_IMAGE_SHAPE. (c) BERT-base
# (BertConfig(num_labels=2), f32) from torch.manual_seed(BERT_SEED) on the
# reference test's separable toy task at BERT_BATCH x BERT_SEQ:
# BERT_STEPS steps with one worker, BERT_DP_STEPS a rank with two. The
# library's f32 attention backward does not repeat bit for bit on the
# card: two runs of the direct loop differed by up to 5.96e-8 (2.2e-7
# relative) over 8 steps, the trainer against the direct loop by 2.24e-8
# (4.1e-7 relative; measured on one NVIDIA H100 80GB HBM3, 700.00
# W). So where the direct loop does not repeat itself, the trainer's
# losses are held to it within BERT_LOSS_RTOL (relative; 24x the larger
# reading, far below what one step moves the loss: 0.68 to 1.30 between
# the first two), bit for bit
# where it does; the first loss comes before any backward and must be
# bit-equal either way.
FORMATS_PARTS = 2
FORMATS_ROWS = 20_000
FORMATS_IMAGES, FORMATS_IMAGE_SHAPE = 4, (96, 128, 3)
BERT_SEED = SEED + 24
BERT_BATCH, BERT_SEQ = 32, 128
BERT_STEPS, BERT_DP_STEPS = 8, 4
BERT_LOSS_RTOL = 1e-5


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
        graphed.stop()
        eager.stop()
    return out, ok


def _rollout_diff(got, want, diff):
    from ray_tpu_torch.rl.ppo import Rollout

    for name, x, y in zip(Rollout._fields, got, want):
        y = y.to(x.device)
        d = ((x - y).abs().max().item() if x.dtype.is_floating_point
             else int((x != y).sum()))
        diff[name] = max(diff.get(name, 0), d)


def _remote_rl(env, dev):
    """Phase 12's runner actors and IMPALA's asynchronous loop
    (module docstring). Returns (readings, checks)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.ppo import clone_params

    out, checks = {}, {}
    wait_s = SERVE_POLL_S * 4
    rt.init(num_cpus=4, ignore_reinit_error=True)
    try:
        algo = (rl.AlgorithmConfig("PPO", device=dev)
                .env_runners(num_env_runners=RL_REMOTE_RUNNERS,
                             num_envs_per_env_runner=RL_ENVS,
                             rollout_fragment_length=RL_ROLLOUT)
                .debugging(seed=SEED).build())
        try:
            params = algo.learner.get_weights()
            local = [rl.EnvRunner(env, RL_ENVS, RL_ROLLOUT, seed=SEED + i,
                                  device=dev)
                     for i in range(RL_REMOTE_RUNNERS)]
            diff = {}
            for _ in range(2):
                host = clone_params(params, device="cpu")
                remote = rt.get([r.sample.remote(host)
                                 for r in algo._runners], timeout=wait_s)
                for got, runner in zip(remote, local):
                    _rollout_diff(got, runner.sample(params), diff)
            checks["runners_equal_local"] = all(
                v <= RL_GRAPH_TOL for v in diff.values())
            iters = [algo.train() for _ in range(2)]
            checks["remote_ppo_finite"] = all(
                np.isfinite(r["loss"]) for r in iters)
        finally:
            algo.stop()
        out["remote_runners"] = {
            "runners": RL_REMOTE_RUNNERS, "max_diff_vs_local": diff,
            "tol": RL_GRAPH_TOL,
            "iteration_ms": [r["time_total_s"] * 1e3 for r in iters],
            "env_steps_per_s": [r["env_steps_per_sec"] for r in iters]}
        # Runner actors at IMPALA's shape without a learner: one alone,
        # then two sampling at once (their graphs on two streams).
        envs, T = RL_IMPALA_SHAPE
        host = clone_params(params, device="cpu")
        pair = [rl.EnvRunner.as_actor(env, envs, T, seed=SEED + i,
                                      device=dev) for i in range(2)]
        rt.get([r.sample.remote(host) for r in pair],
               timeout=wait_s)  # captures
        rates = {}
        for name, runners in (("one", pair[:1]), ("two_at_once", pair)):
            t0 = time.perf_counter()
            for _ in range(RL_TIMED):
                rt.get([r.sample.remote(host) for r in runners],
                       timeout=wait_s)
            rates[name] = (envs * T * RL_TIMED * len(runners)
                           / (time.perf_counter() - t0))
        for r in pair:
            rt.kill(r)
        one_runner = rates["one"]
        impala = rl.IMPALA(env, rl.IMPALAConfig(**RL_IMPALA_LOOP),
                           num_runners=2, num_envs=envs, rollout_len=T,
                           seed=SEED, device=dev)
        try:
            first, last = (impala.train(num_updates=n)
                           for n in RL_IMPALA_UPDATES)
        finally:
            impala.stop()
        checks["impala_learns"] = bool(
            np.isfinite(last["loss"])
            and last["episode_len_mean"] > RL_IMPROVE
            * first["episode_len_mean"])
        checks["impala_overlap"] = last["collection_update_overlap_s"] > 0
        out["impala_loop"] = {
            "config": {**RL_IMPALA_LOOP, "num_runners": 2, "num_envs": envs,
                       "rollout_len": T, "updates": RL_IMPALA_UPDATES},
            "first": first, "last": last,
            "one_runner_env_steps_per_s": one_runner,
            "twice_one_runner_env_steps_per_s": 2 * one_runner,
            "two_runners_at_once_env_steps_per_s": rates["two_at_once"]}
    finally:
        rt.shutdown()
    out["checks"] = checks
    return out, checks


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
    remote, remote_checks = _remote_rl(env, dev)
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
        "impala": impala, "remote": remote,
        "ppo_episode_len_mean": lens, "ppo_greedy_return": greedy,
        "ppo_losses": [r["loss"] for r in ppo],
        "dqn_losses": dqn_losses,
        "multi_agent": [{"mean_step_reward": r["mean_step_reward"],
                         "losses": r["losses"]} for r in ma_out],
        "readings": readings, "card": card}
    emit({"phase": "rl", **result})
    ok = (rollout_ok and dones > 0 and update_ok and impala_ok
          and all(remote_checks.values())
          and lens[-1] > RL_IMPROVE * lens[0]
          and all(np.isfinite(dqn_losses))
          and all(np.isfinite(list(r["losses"].values())).all()
                  for r in ma_out))
    if not ok:
        raise AssertionError(
            f"rl: graph and eager apart, a remote check failed, PPO did "
            f"not improve past "
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
    _dag_actor_backend(
        dev, card, results["chain_1k_noop[static]"]["sync_exec_p50_us"])
    return results


def _run_actor_dag(leaf, *inputs):
    """Compile ``leaf`` to the actor backend, execute it once per input,
    tear it down: (outputs, the compiled DAG)."""
    compiled = leaf.experimental_compile(backend="actor")
    try:
        return [compiled.execute(x).get(timeout=SERVE_POLL_S)
                for x in inputs], compiled
    finally:
        compiled.teardown()


def _dag_actor_backend(dev, card, chain_p50_us):
    """Phase 8's actor-loop backend on the one-process
    runtime (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    class Plus:
        def __init__(self, n):
            self.n = n

        def apply(self, x):
            return x + self.n

    @rt.remote
    class Same:
        def apply(self, x):
            return x

    @rt.remote
    class Gate:
        def __init__(self):
            self.seen = []

        def apply(self, x):
            self.seen.append((type(x).__name__, str(x.device)))
            return x

    @rt.remote
    class Bad:
        def apply(self, x):
            raise ValueError("stage failed")

    @rt.remote
    class Rank:
        def __init__(self, rank):
            self.rank = rank

        def collective_join(self, world_size, rank, backend, group):
            col.init_collective_group(world_size, rank, backend, group)
            return rank

        def reduce(self, group):
            return col.allreduce(torch.full((1024,), float(self.rank + 1),
                                            device=dev), group_name=group)

    @rt.remote
    def scale(x):
        return x * 2.0

    @rt.remote
    def shift(x):
        return x + 1.0

    @rt.remote
    def finish(x):
        return x - 3.0

    checks, out = {}, {"card": card}
    rt.init(num_cpus=4, ignore_reinit_error=True)
    try:
        # (a) The 4-stage pipeline: values, then its latency.
        with InputNode() as inp:
            node = inp
            for i in range(1, DAG_ACTOR_STAGES + 1):
                node = Plus.remote(i).apply.bind(node)
        compiled = node.experimental_compile(backend="actor")
        try:
            got = [compiled.execute(i).get(timeout=SERVE_POLL_S)
                   for i in range(DAG_ACTOR_EXECS)]
            offset = sum(range(1, DAG_ACTOR_STAGES + 1))
            checks["pipeline_values"] = got == [
                i + offset for i in range(DAG_ACTOR_EXECS)]
            lat = []
            for i in range(DAG_ACTOR_TIMED):
                t0 = time.perf_counter()
                compiled.execute(i).get(timeout=SERVE_POLL_S)
                lat.append(time.perf_counter() - t0)
            # Two executions in flight (the channels hold two each).
            t0 = time.perf_counter()
            pending = []
            for i in range(DAG_ACTOR_TIMED):
                pending.append(compiled.execute(i))
                if len(pending) == 2:
                    pending.pop(0).get(timeout=SERVE_POLL_S)
            for ref in pending:
                ref.get(timeout=SERVE_POLL_S)
            pipelined = (time.perf_counter() - t0) / DAG_ACTOR_TIMED
        finally:
            compiled.teardown()
        out["pipeline"] = {
            "stages": DAG_ACTOR_STAGES, "execs_checked": DAG_ACTOR_EXECS,
            "sync_exec_p50_us": _p50(lat) * 1e6,
            "sync_exec_p99_us": sorted(lat)[int(0.99 * len(lat))] * 1e6,
            "pipelined_us_per_execute": pipelined * 1e6,
            "torch_executor_chain_1k_sync_p50_us": chain_p50_us}
        # (b) A CUDA tensor through two actor stages, by reference.
        with InputNode() as inp:
            leaf = Same.remote().apply.bind(Same.remote().apply.bind(inp))
        x = torch.arange(1024.0, device=dev)
        (y,), _ = _run_actor_dag(leaf, x)
        checks["same_tensor"] = y is x and y.device == x.device
        # (c) tests/test_dag.py's mixed DAG on CUDA tensors.
        g = Gate.remote()
        with InputNode() as inp:
            a = scale.bind(inp).with_tensor_transport("device")
            b = shift.bind(a).with_tensor_transport("device")
            d = finish.bind(g.apply.bind(b)).with_tensor_transport("device")
        x = torch.arange(8, dtype=torch.float32, device=dev)
        (y,), compiled = _run_actor_dag(d, x)
        seen = list(g._runtime.instance.seen)
        driver_stages = len(compiled._loops["__driver__"])
        checks["mixed"] = (driver_stages == 2
                           and seen == [("Tensor", str(x.device))]
                           and y.device == x.device
                           and torch.equal(y, x * 2.0 + 1.0 - 3.0))
        out["mixed"] = {"driver_stages": driver_stages, "actor_saw": seen}
        # (d) A stage's error reaches get.
        with InputNode() as inp:
            leaf = Bad.remote().apply.bind(inp)
        try:
            _run_actor_dag(leaf, 1)
            checks["stage_error"] = False
        except ValueError as exc:
            checks["stage_error"] = "stage failed" in str(exc)
        # (e) An allreduce of DAG_ACTOR_RANKS actor ranks on the card.
        ranks = [Rank.remote(i) for i in range(DAG_ACTOR_RANKS)]
        col.create_collective_group(ranks, DAG_ACTOR_RANKS,
                                    list(range(DAG_ACTOR_RANKS)),
                                    group_name="chip_smoke")
        sums = rt.get([r.reduce.remote("chip_smoke") for r in ranks],
                      timeout=SERVE_POLL_S)
        total = float(sum(range(1, DAG_ACTOR_RANKS + 1)))
        checks["allreduce"] = all(
            o.device == x.device and torch.equal(
                o, torch.full((1024,), total, device=dev)) for o in sums)
        col.destroy_collective_group("chip_smoke")
    finally:
        rt.shutdown()
    out["checks"] = checks
    emit({"phase": "dag_actor", **out})
    if not all(checks.values()):
        raise AssertionError(f"dag_actor: a check failed: {checks}")
    return out


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


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _timed_stream(items):
    """Consume a token iterator: (tokens, seconds to the first token,
    gaps between tokens), timed from the call that made ``items``."""
    t0 = last = time.perf_counter()
    toks, ttft, gaps = [], None, []
    for tok in items():
        now = time.perf_counter()
        if toks:
            gaps.append(now - last)
        else:
            ttft = now - t0
        last = now
        toks.append(tok)
    return toks, ttft, gaps


def _http_tokens(proxy, name, prompt, new_tokens):
    """POST /<name>?stream=1 and read the chunked JSON lines as they
    arrive."""
    import http.client

    conn = http.client.HTTPConnection(proxy.host, proxy.port,
                                      timeout=SERVE_POLL_S * 4)
    try:
        conn.request("POST", f"/{name}?stream=1", body=json.dumps(
            {"prompt": prompt, "max_new_tokens": new_tokens}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()!r}")
        while True:
            line = resp.readline()
            if not line:
                return
            item = json.loads(line)
            if not isinstance(item, int):
                raise AssertionError(f"HTTP stream item {item!r}")
            yield item
    finally:
        conn.close()


def _engine_streams(cfg, dev, prompts, new_tokens):
    """The engine's own generate of each prompt alone, timed."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    engine = InferenceEngine(EngineConfig(
        model=cfg, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
        device=str(dev)))
    out = []
    try:
        for p in prompts:
            out.append(_timed_stream(
                lambda: engine.generate(p, max_new_tokens=new_tokens)))
            if not engine.wait_idle(120):
                raise AssertionError("engine did not go idle")
    finally:
        engine.shutdown()
    return out


def _served_streams(handle, prompts, new_tokens):
    return [_timed_stream(lambda: handle.options(stream=True).remote(
        {"prompt": p, "max_new_tokens": new_tokens})) for p in prompts]


def _served_concurrent(handle, prompts, new_tokens):
    outs = [None] * len(prompts)

    def consume(i):
        outs[i] = list(handle.options(stream=True).remote(
            {"prompt": prompts[i], "max_new_tokens": new_tokens}))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads) or any(o is None for o in outs):
        raise AssertionError("concurrent served requests did not complete")
    return outs


def _must_equal(name, got, want):
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{name}: streams {bad} differ from the "
                             f"engine's own generate")


def _replica_stats(info):
    import ray_tpu_torch as rt

    return [rt.get(r.handle_request.remote("stats", (), {}),
                   timeout=SERVE_POLL_S) for r in info.replicas]


def _serve_cancel(handle, prompt):
    """A SERVE_CANCEL_TOKENS stream closed after its first token: its
    blocks are freed within a bounded poll."""
    gen = handle.options(stream=True).remote(
        {"prompt": prompt, "max_new_tokens": SERVE_CANCEL_TOKENS})
    next(gen)
    busy = handle.stats.remote().result(timeout=SERVE_POLL_S)
    t0 = time.perf_counter()
    gen.close()
    deadline = time.monotonic() + SERVE_POLL_S
    while time.monotonic() < deadline:
        st = handle.stats.remote().result(timeout=SERVE_POLL_S)
        if st["blocks_in_use"] == 0 and st["running"] == 0:
            break
        time.sleep(0.01)
    freed_s = time.perf_counter() - t0
    if st["blocks_in_use"] or st["running"]:
        raise AssertionError(f"cancelled stream left blocks_in_use "
                             f"{st['blocks_in_use']}, running "
                             f"{st['running']}")
    return {"blocks_in_use_before_close": busy["blocks_in_use"],
            "freed_within_s": freed_s}


def _serve_prefix_routing(cfg, dev, rng):
    """Two replicas warmed with one system prompt: a request with that
    prefix is routed by overlap (prefix_routed) to a replica whose
    prefix_cache_hits rises."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, build_llm_app
    from ray_tpu_torch.serve.controller import get_or_create_controller

    system = rng.integers(1, cfg.vocab_size, SERVE_WARM_PREFIX).tolist()
    tail = rng.integers(1, cfg.vocab_size, 40).tolist()
    handle = serve.run(build_llm_app(
        EngineConfig(model=cfg, num_blocks=SERVE_NUM_BLOCKS,
                     block_size=BLOCK_SIZE, device=str(dev)),
        name="llm_prefix", num_replicas=2, warm_prefix=system))
    ctrl = get_or_create_controller()
    info = ctrl.deployment_info("llm_prefix")
    ctrl.poll_prefix_digests_of(info)   # the poll loop's work, at once
    rs = info.replica_set
    before = [s["prefix_cache_hits"] for s in _replica_stats(info)]
    routed = rs.prefix_routed
    toks = list(handle.options(stream=True).remote(
        {"prompt": system + tail, "max_new_tokens": 4}))
    after = [s["prefix_cache_hits"] for s in _replica_stats(info)]
    rose = [i for i, (a, b) in enumerate(zip(before, after)) if b > a]
    if rs.prefix_routed != routed + 1 or len(rose) != 1 or len(toks) != 4:
        raise AssertionError(
            f"prefix routing: prefix_routed {routed} -> {rs.prefix_routed}, "
            f"prefix_cache_hits {before} -> {after}")
    serve.delete("llm_prefix")
    return {"replicas": 2, "warm_prefix_tokens": SERVE_WARM_PREFIX,
            "prefix_routed": rs.prefix_routed,
            "prefix_overlap_tokens": rs.prefix_overlap_tokens,
            "prefix_cache_hits_before": before,
            "prefix_cache_hits_after": after}


def _runtime_readings():
    """us per trivial task and per actor call, submitted at once and one
    at a time."""
    import ray_tpu_torch as rt

    @rt.remote
    def noop(i):
        return i

    @rt.remote
    class Echo:
        def echo(self, i):
            return i

    actor = Echo.remote()
    out = {}
    for name, call in (("task", noop.remote), ("actor_call",
                                               actor.echo.remote)):
        rt.get([call(i) for i in range(100)], timeout=SERVE_POLL_S)  # warm
        t0 = time.perf_counter()
        got = rt.get([call(i) for i in range(SERVE_TASKS)],
                     timeout=SERVE_POLL_S * 4)
        batched = (time.perf_counter() - t0) / SERVE_TASKS
        if got != list(range(SERVE_TASKS)):
            raise AssertionError(f"{name}: wrong results")
        t0 = time.perf_counter()
        for i in range(SERVE_SYNC_CALLS):
            if rt.get(call(i), timeout=SERVE_POLL_S) != i:
                raise AssertionError(f"{name}: wrong result")
        sync = (time.perf_counter() - t0) / SERVE_SYNC_CALLS
        out[f"{name}_us_batched"] = batched * 1e6
        out[f"{name}_us_sync"] = sync * 1e6
    rt.kill(actor)
    return out


def _cuda_object_store(dev):
    """A CUDA tensor's put/get and task round trips stay on the card with
    equal values; the round trip timed beside the two device copies it
    makes (put keeps a copy, get hands out another)."""
    import ray_tpu_torch as rt

    gen = torch.Generator(dev).manual_seed(SEED)
    x = torch.randn(*SERVE_TENSOR_SHAPE, device=dev, generator=gen)
    back = rt.get(rt.put(x), timeout=SERVE_POLL_S)
    if back.device != x.device or not torch.equal(back, x):
        raise AssertionError(f"put/get gave {back.device}, equal "
                             f"{torch.equal(back.cpu(), x.cpu())}")

    @rt.remote
    def twice(t):
        if t.device != x.device:
            raise AssertionError(f"task argument on {t.device}")
        return t * 2.0

    out = rt.get(twice.remote(rt.put(x)), timeout=SERVE_POLL_S)
    if out.device != x.device or not torch.equal(out, x * 2.0):
        raise AssertionError("task round trip differs")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_TENSOR_ITERS):
        rt.get(rt.put(x), timeout=SERVE_POLL_S)
    torch.cuda.synchronize()
    round_trip = (time.perf_counter() - t0) / SERVE_TENSOR_ITERS * 1e3
    two_clones = cuda_ms(lambda: x.clone().clone(), iters=SERVE_TENSOR_ITERS)
    return {"shape": list(SERVE_TENSOR_SHAPE), "dtype": "float32",
            "bytes": x.numel() * x.element_size(),
            "device": str(back.device), "put_get_equal": True,
            "task_equal": True, "put_get_ms": round_trip,
            "two_device_copies_ms": two_clones}


def _prefill_stats(handle):
    return handle.stats.remote().result(timeout=SERVE_POLL_S)


def _serve_disagg(cfg, dev, prompts, want, shared, shared_want, new_tokens):
    """Phase 13's disaggregated serving of the flagship (module
    docstring). Returns its readings; raises on a failed check."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (
        DisaggHandle,
        EngineConfig,
        build_disagg_llm_app,
    )
    from ray_tpu_torch.serve.controller import get_or_create_controller

    papp, dapp = build_disagg_llm_app(EngineConfig(
        model=cfg, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
        device=str(dev)))
    serve.run(papp, name="prefill")
    serve.run(dapp, name="decode")
    h = DisaggHandle.from_deployments()
    ph = serve.get_deployment_handle("llm-prefill")
    dh = serve.get_deployment_handle("llm-decode")
    runs, kv_bytes = [], []
    for p in prompts:
        before = _prefill_stats(ph)["kv_bytes_published"]
        runs.append(_timed_stream(lambda: h.stream(
            {"prompt": p, "max_new_tokens": new_tokens})))
        kv_bytes.append(_prefill_stats(ph)["kv_bytes_published"] - before)
    _must_equal("disagg", [r[0] for r in runs], want)
    if (h.paired, h.prefill_fallbacks) != (len(prompts), 0):
        raise AssertionError(f"disagg: paired {h.paired}, prefill "
                             f"fallbacks {h.prefill_fallbacks}")
    # A prompt sharing the cached prompt's blocks ships only its tail.
    ctrl = get_or_create_controller()
    ctrl.poll_prefix_digests_of(ctrl.deployment_info("llm-decode"))
    skip = h._plan_skip_blocks(shared, BLOCK_SIZE)
    before = _prefill_stats(ph)["kv_blocks_published"]
    planned = list(h.stream_planned(
        {"prompt": shared, "max_new_tokens": new_tokens}, BLOCK_SIZE))
    shipped = _prefill_stats(ph)["kv_blocks_published"] - before
    holds = -(-len(shared) // BLOCK_SIZE)
    _must_equal("disagg planned", [planned], [shared_want])
    if not 0 < shipped < holds:
        raise AssertionError(f"disagg planned: shipped {shipped} of "
                             f"{holds} blocks (skip {skip})")
    # The ledger balances: every publication acked, no block held.
    deadline = time.monotonic() + SERVE_POLL_S
    while True:
        st = _prefill_stats(ph)
        if ((st["kv_publications_outstanding"] == 0
                and st["blocks_in_use"] == 0)
                or time.monotonic() > deadline):
            break
        time.sleep(0.01)
    ledger = {k: st[k] for k in (
        "kv_publishes", "kv_acks", "kv_expiries",
        "kv_publications_outstanding", "blocks_in_use", "held_sequences",
        "kv_blocks_published", "kv_bytes_published")}
    if (ledger["kv_acks"] != ledger["kv_publishes"]
            or ledger["kv_publishes"] != len(prompts) + 1
            or ledger["kv_publications_outstanding"]
            or ledger["blocks_in_use"] or ledger["held_sequences"]):
        raise AssertionError(f"disagg: the ledger does not balance: "
                             f"{ledger}")
    # A dead ticket falls back to a local re-prefill.
    bad = {"prompt": prompts[0], "max_new_tokens": new_tokens,
           "_disagg": {"ref": None, "first_token": want[0][0],
                       "pub_id": -1, "start_block": 0, "blocks": 0,
                       "block_size": BLOCK_SIZE, "bytes": 0}}
    t0 = time.perf_counter()
    dead = list(dh.options(stream=True).remote(bad))
    dead_s = time.perf_counter() - t0
    _must_equal("disagg dead ticket", [dead], [want[0]])
    dst = dh.stats.remote().result(timeout=SERVE_POLL_S)
    if (dst["disagg_adopted"], dst["disagg_fallbacks"]) != (
            len(prompts) + 1, 1):
        raise AssertionError(f"disagg: adopted {dst['disagg_adopted']}, "
                             f"fallbacks {dst['disagg_fallbacks']}")
    serve.delete("llm-prefill")
    serve.delete("llm-decode")
    return {"runs": runs, "paired": h.paired,
            "prefill_fallbacks": h.prefill_fallbacks,
            "kv_bytes_per_prompt": kv_bytes,
            "planned": {"prompt_len": len(shared), "skip_blocks": skip,
                        "blocks_shipped": shipped, "blocks_held": holds,
                        "equals_engine": True},
            "ledger": ledger, "dead_ticket_equals_engine": True,
            "dead_ticket_s": dead_s,
            "decode_pool": {k: dst[k] for k in (
                "disagg_adopted", "disagg_fallbacks", "blocks_grafted")},
            "ttft_decomposition": dst["ttft_decomposition"]}


def phase_serve(dev, card, cfg, lens, new_tokens):
    """Phase 13 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, build_llm_app

    fa = _flash_module()
    prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                       cfg.vocab_size)
    gqa = dataclasses.replace(cfg, n_kv_heads=4)
    gqa_prompts = prompts[:SERVE_GQA_PROMPTS]

    def app(model, name="llm"):
        return build_llm_app(EngineConfig(
            model=model, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
            device=str(dev)), name=name)

    # A throwaway engine first, so the timed engine-direct run does not
    # pay the process's first-use costs (its prompt shares no block with
    # the timed ones, and that engine's cache goes with it).
    _engine_streams(cfg, dev, [[1] * (2 * BLOCK_SIZE)], 4)
    direct = _engine_streams(cfg, dev, prompts, new_tokens)
    direct_gqa = _engine_streams(gqa, dev, gqa_prompts, new_tokens)
    want = [d[0] for d in direct]
    shared = prompts[SERVE_DISAGG_SHARED] + np.random.default_rng(
        SEED + 4).integers(1, cfg.vocab_size, SERVE_DISAGG_TAIL).tolist()
    (shared_want, _, _), = _engine_streams(cfg, dev, [shared], new_tokens)
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        with _counts_kept(fa):
            for n in _COUNTERS:
                setattr(fa, n, 0)
            handle = serve.run(app(cfg))
            served = _served_streams(handle, prompts, new_tokens)
            _must_equal("served (handle)", [s[0] for s in served], want)
            proxy = serve.start_proxy(port=0)
            via_http = [_timed_stream(lambda: _http_tokens(
                proxy, "llm", p, new_tokens)) for p in prompts]
            _must_equal("served (HTTP)", [s[0] for s in via_http], want)
            cancel = _serve_cancel(handle, prompts[0])
            serve.delete("llm")
            fresh = serve.run(app(cfg, "llm_concurrent"))
            concurrent = _served_concurrent(fresh, prompts, new_tokens)
            _must_equal("served (concurrent)", concurrent, want)
            serve.delete("llm_concurrent")
            gqa_handle = serve.run(app(gqa, "llm_gqa"))
            served_gqa = _served_streams(gqa_handle, gqa_prompts,
                                         new_tokens)
            _must_equal("served GQA", [s[0] for s in served_gqa],
                        [d[0] for d in direct_gqa])
            serve.delete("llm_gqa")
            disagg = _serve_disagg(cfg, dev, prompts, want, shared,
                                   shared_want, new_tokens)
            counts = {n: getattr(fa, n) for n in _COUNTERS}
        if any(counts.values()):
            raise AssertionError(
                f"the served path launched flash kernels or took the "
                f"plain route: {counts}")
        prefix = _serve_prefix_routing(cfg, dev,
                                       np.random.default_rng(SEED + 3))
        store = _cuda_object_store(dev)
        runtime = _runtime_readings()
    finally:
        serve.shutdown()
        rt.shutdown()

    def readings(runs):
        return {"ttft_p50_s": _p50([r[1] for r in runs]),
                "token_gap_p50_s": _p50([g for r in runs for g in r[2]])}

    out = {"phase": "serve",
           "model": {"vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
                     "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                     "n_kv_heads": cfg.n_kv_heads,
                     "dtype": _dtype_name(cfg.dtype)},
           "requests": len(prompts), "prompt_lens": lens,
           "new_tokens": new_tokens,
           "handle_equals_engine": True, "http_equals_engine": True,
           "concurrent_equals_sequential": True,
           "gqa": {"n_kv_heads": gqa.n_kv_heads,
                   "requests": len(gqa_prompts), "equals_engine": True},
           "flash_counters_on_served_path": counts,
           "engine_direct": readings(direct),
           "handle": readings(served), "http": readings(via_http),
           "disagg": {**{k: v for k, v in disagg.items() if k != "runs"},
                      "equals_engine": True,
                      **readings(disagg["runs"]),
                      "transfer_p50_s": disagg["ttft_decomposition"].get(
                          "transfer_p50_s")},
           "cancel": cancel, "prefix_routing": prefix,
           "cuda_object_store": store, "runtime": runtime, "card": card}
    emit(out)
    return out


# ------------------------------------------------------- phase 14: trainer
def _trainer_loop(config):
    """Phase 14's train_loop_per_worker: the flagship's bf16 AdamW steps
    (make_train_step over f32 masters) on the worker's dataset shard,
    resumed from the session's checkpoint, with a checkpoint of the
    parameters, the AdamW state and the step every TRAINER_CKPT_EVERY
    steps, and an optional planted failure before step
    ``config["fail_before"]`` of a run that started from step 0. Module
    level, so that the trainer's state stores it by name."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train

    cfg, dev = config["cfg"], torch.device(config["device"])
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    start, ckpt = 0, train.get_checkpoint()
    if ckpt is not None:
        tree = ckpt.to_pytree(device=dev)
        src = dict(_named_leaves(tree["params"]))
        with torch.no_grad():
            for name, t in _named_leaves(params):
                t.copy_(src[name])
        step.optimizer.load_state_dict(tree["opt"])
        start = tree["step"]
        del tree, src
    batches = train.get_dataset_shard("train").iter_torch_batches(
        batch_size=TRAIN_BATCH, device=dev)
    for _ in range(start):   # the batches of the steps already taken
        next(batches)
    for i in range(start + 1, config["steps"] + 1):
        t0 = time.perf_counter()
        tokens = next(batches)["tokens"]
        batch_s = time.perf_counter() - t0
        if i == config.get("fail_before") and start == 0:
            config["failed_at"] = time.perf_counter()
            raise RuntimeError(f"planted failure before step {i}")
        t0 = time.perf_counter()
        loss = step(tokens[:, :-1], tokens[:, 1:]).item()
        metrics = {"step": i, "loss": loss, "batch_s": batch_s,
                   "step_s": time.perf_counter() - t0,
                   "t": time.perf_counter()}
        ckpt = None
        if i % TRAINER_CKPT_EVERY == 0:
            t0 = time.perf_counter()
            ckpt = train.Checkpoint.from_pytree(
                {"params": params, "opt": step.optimizer.state_dict(),
                 "step": i},
                os.path.join(config["tmp"], f"step{i}_{time.time_ns()}"))
            metrics["save_s"] = time.perf_counter() - t0
        train.report(metrics, checkpoint=ckpt)


def _trainer_direct(cfg, dev, tokens, steps):
    """The oracle of phase 14: make_train_step called directly on the
    same batches from the same seed. Its losses, step times and the
    K1/K3/K4 launches (and plain routes) of the run."""
    from ray_tpu_torch import models as tm

    fa = _flash_module()
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, step_s = [], []
    _zero_counts()
    plain = fa.plain_routes
    for i in range(steps):
        batch = torch.tensor(tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                             device=dev)
        t0 = time.perf_counter()
        losses.append(step(batch[:, :-1], batch[:, 1:]).item())
        step_s.append(time.perf_counter() - t0)
    counts = _counts()
    del params, step
    torch.cuda.empty_cache()
    return losses, step_s, counts, fa.plain_routes - plain


def _same_leaves(a, b):
    """Two checkpoints' saved trees alike bit for bit: the same structure
    and every leaf's bytes."""
    def read(d):
        with open(os.path.join(d, "pytree", "structure.pkl"), "rb") as f:
            return f.read()

    if read(a) != read(b):
        return False
    with np.load(os.path.join(a, "pytree", "leaves.npz")) as x, \
            np.load(os.path.join(b, "pytree", "leaves.npz")) as y:
        return x.files == y.files and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
            for k in x.files)


def _mlp_loop(config):
    """Phase 14 (e)'s loop: an MLP at the flagship's widths under
    prepare_model (rank 0's initial weights broadcast, gradients averaged
    once per backward pass), TRAINER_MLP_STEPS f32 AdamW steps on the
    rank's shard; the ranks' parameters gathered at the end."""
    import torch.nn as nn

    from ray_tpu_torch import train
    from ray_tpu_torch.collective import collective
    from ray_tpu_torch.train.torch import prepare_model

    ctx = train.get_context()
    dev = torch.device(config["device"])
    d, f = config["widths"]
    model = nn.Sequential(nn.Linear(d, f), nn.SiLU(), nn.Linear(f, d))
    rng = np.random.default_rng(SEED + 100 + ctx.get_world_rank())
    with torch.no_grad():   # per-rank initial weights, drawn apart
        for p in model.parameters():
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape)
                                      / np.sqrt(p.shape[-1])
                                      ).astype(np.float32)))
    model = prepare_model(model.to(dev))
    opt = torch.optim.AdamW(model.parameters(), lr=TRAINER_MLP_LR)
    rows = TRAINER_MLP_ROWS // ctx.get_world_size()
    batch = next(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=rows, device=dev))
    losses, step_s = [], []
    for _ in range(TRAINER_MLP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = F.mse_loss(model(batch["x"]), batch["y"])
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    flats = collective.allgather(flat, group_name=ctx.collective_group)
    train.report({"losses": losses, "step_s": step_s, "rows": rows,
                  "ranks_equal": all(torch.equal(g, flats[0])
                                     for g in flats),
                  "params": flat.cpu()})


def _two_ranks(dev, cfg, ds_of):
    """Phase 14 (e): TorchTrainer with two workers on the card against
    one worker on the whole batch, with the allreduce of prepare_model
    timed (a sync after each call)."""
    from ray_tpu_torch.collective import collective
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    ar_s = []
    allreduce = collective.allreduce

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = allreduce(*args, **kwargs)
        torch.cuda.synchronize()
        ar_s.append(time.perf_counter() - t0)
        return out

    config = {"device": str(dev), "widths": (cfg.d_model, cfg.d_ff)}
    runs = {}
    with _patched(collective, "allreduce", timed):
        for n in (2, 1):
            runs[n] = TorchTrainer(
                _mlp_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=n, use_gpu=True),
                datasets={"train": ds_of()}).fit().metrics
    two, one = runs[2], runs[1]
    diff = (two["params"] - one["params"]).abs().max().item()
    later = sorted(two["step_s"][1:])
    p50 = later[len(later) // 2]
    return {"ranks": 2, "widths": [cfg.d_model, cfg.d_ff, cfg.d_model],
            "rows_per_rank": two["rows"], "steps": TRAINER_MLP_STEPS,
            "ranks_bit_equal": two["ranks_equal"],
            "max_abs_diff_vs_one_worker": diff, "tol": TRAINER_MLP_TOL,
            "losses": two["losses"], "losses_one_worker": one["losses"],
            "step_ms_p50": p50 * 1e3,
            "one_worker_step_ms_p50": sorted(one["step_s"][1:])[
                len(one["step_s"][1:]) // 2] * 1e3,
            "allreduce_calls": len(ar_s),
            "allreduce_ms_mean": 1e3 * sum(ar_s) / max(len(ar_s), 1),
            "allreduce_share_of_step": (sum(ar_s) / max(len(ar_s), 1)) / p50}


def phase_trainer(dev, card, cfg):
    """Phase 14 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.data.filesystem import MemoryFilesystem
    from ray_tpu_torch.train import (
        Checkpoint,
        CheckpointConfig,
        CheckpointStore,
        DataParallelTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )

    t_phase = time.perf_counter()
    fa = _flash_module()
    L, n_all = cfg.n_layers, TRAINER_STEPS + TRAINER_MORE
    tokens = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, (n_all * TRAIN_BATCH, TRAIN_LEN + 1))
    direct, direct_s, direct_counts, direct_plain = _trainer_direct(
        cfg, dev, tokens, n_all)
    tmp_root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    cc = CheckpointConfig(num_to_keep=TRAINER_KEEP, async_save=True)
    checks, out, fetched = {}, {}, []

    def loop_config(name, steps, **extra):
        return {"cfg": cfg, "device": str(dev), "steps": steps,
                "tmp": os.path.join(tmp_root, name), **extra}

    def stored(name):
        store = CheckpointStore(f"{TRAINER_ROOT}/{name}")
        try:
            return store.list_checkpoints()
        finally:
            store.close()

    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        ds = data.from_columns({"tokens": tokens}, parallelism=4)
        # (a) the trainer against the direct loop.
        _zero_counts()
        plain = fa.plain_routes
        t0 = time.perf_counter()
        res_a = DataParallelTrainer(
            _trainer_loop, train_loop_config=loop_config("a", TRAINER_STEPS),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="a", storage_path=TRAINER_ROOT,
                                 checkpoint_config=cc),
            datasets={"train": ds}).fit()
        fit_a_s = time.perf_counter() - t0
        counts_a, plain_a = _counts(), fa.plain_routes - plain
        hist = res_a.metrics_history
        listed_a = stored("a")
        checks["a_losses_bit_equal"] = [m["loss"] for m in hist] == direct[
            :TRAINER_STEPS]
        checks["a_launches_per_step"] = (
            counts_a == _want_counts("wgmma", TRAINER_STEPS * L,
                                     TRAINER_STEPS * L)
            and direct_counts == _want_counts("wgmma", n_all * L, n_all * L))
        checks["a_plain_routes_0"] = plain_a == 0 and direct_plain == 0
        checks["a_retention"] = len(listed_a) == TRAINER_KEEP
        later = sorted(m["step_s"] for m in hist[1:])
        direct_later = sorted(direct_s[1:])
        out["a"] = {
            "steps": len(hist), "losses": [m["loss"] for m in hist],
            "direct_losses": direct[:TRAINER_STEPS],
            "launches_per_step": {k: v / TRAINER_STEPS
                                  for k, v in counts_a.items() if v},
            "direct_launches_per_step": {k: v / n_all for k, v in
                                         direct_counts.items() if v},
            "plain_routes": plain_a, "stored": len(listed_a),
            "fit_s": fit_a_s,
            "step_ms_p50": later[len(later) // 2] * 1e3,
            "direct_step_ms_p50": direct_later[len(direct_later) // 2] * 1e3,
            "step_ms": [m["step_s"] * 1e3 for m in hist],
            "direct_step_ms": [t * 1e3 for t in direct_s[:TRAINER_STEPS]],
            "iter_torch_batches_s_per_batch": sum(
                m["batch_s"] for m in hist) / len(hist),
            "checkpoint_save_s": [m["save_s"] for m in hist
                                  if "save_s" in m]}

        # (d) URI round trips of the step-12 checkpoint, then the store's
        # persist and persist_async (whose wait raises an upload error).
        ck = res_a.checkpoint
        nbytes = sum(f.stat().st_size for f in Path(ck.path).rglob("*")
                     if f.is_file())
        trips = {}
        for kind, uri in (("memory", f"{TRAINER_ROOT}/roundtrip"),
                          ("file", f"file://{tmp_root}/roundtrip")):
            t0 = time.perf_counter()
            ck.to_uri(uri)
            up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = Checkpoint.from_uri(uri)
            down_s = time.perf_counter() - t0
            same = _same_leaves(ck.path, back.path)
            shutil.rmtree(back.path)
            trips[kind] = {"upload_s": up_s, "download_s": down_s,
                           "bit_equal": same}
            checks[f"d_{kind}_bit_equal"] = same
        try:
            ck.to_uri("s3://smoke14/x")
            s3 = "no error"
        except Exception as exc:  # noqa: BLE001 — the type is the check
            s3 = type(exc).__name__
        checks["d_s3_value_error"] = s3 == "ValueError"
        store = CheckpointStore(f"{TRAINER_ROOT}/timing")
        try:
            t0 = time.perf_counter()
            store.persist(ck, "checkpoint_sync")
            persist_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            store.persist_async(ck, "checkpoint_async")
            dispatch_s = time.perf_counter() - t0
            store.wait(timeout=300)
            async_s = time.perf_counter() - t0
        finally:
            store.close()
        out["d"] = {"checkpoint_bytes": nbytes, "round_trips": trips,
                    "s3": s3, "persist_s": persist_s,
                    "persist_async_return_s": dispatch_s,
                    "persist_async_done_s": async_s}
        shutil.rmtree(os.path.join(tmp_root, "a"))

        # (b) a planted failure before step TRAINER_FAIL_AT: the group
        # restarts from the step-8 checkpoint (the local copy, as the
        # upload may still run).
        config_b = loop_config("b", TRAINER_STEPS,
                               fail_before=TRAINER_FAIL_AT)
        res_b = DataParallelTrainer(
            _trainer_loop, train_loop_config=config_b,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name="b", storage_path=TRAINER_ROOT, checkpoint_config=cc,
                failure_config=FailureConfig(max_failures=1)),
            datasets={"train": ds}).fit()
        hist = res_b.metrics_history
        checks["b_resumed_at_fail_step"] = [m["step"] for m in hist] == list(
            range(TRAINER_FAIL_AT, TRAINER_STEPS + 1))
        checks["b_losses_bit_equal"] = [m["loss"] for m in hist] == direct[
            TRAINER_FAIL_AT - 1:TRAINER_STEPS]
        try:
            DataParallelTrainer(
                _trainer_loop,
                train_loop_config=loop_config("b0", TRAINER_STEPS,
                                              fail_before=1),
                run_config=RunConfig(
                    failure_config=FailureConfig(max_failures=0)),
                datasets={"train": ds}).fit()
            exhausted = "no error"
        except Exception as exc:  # noqa: BLE001 — the type is the check
            exhausted = type(exc).__name__
        checks["b_exhausted_training_failed_error"] = (
            exhausted == "TrainingFailedError")
        out["b"] = {"steps": [m["step"] for m in hist],
                    "losses": [m["loss"] for m in hist],
                    "restart_s": hist[0]["t"] - hist[0]["step_s"]
                    - config_b["failed_at"] if hist else None,
                    "max_failures_0_error": exhausted}
        shutil.rmtree(os.path.join(tmp_root, "b"))

        # (c) restore run "a" from its URI: 4 more steps.
        restored = DataParallelTrainer.restore(
            f"{TRAINER_ROOT}/a", train_loop_per_worker=_trainer_loop,
            train_loop_config=loop_config("c", n_all),
            datasets={"train": ds})
        if restored._restore_from is not None:
            fetched.append(restored._restore_from.path)
        state = (restored._run_config.name == "a"
                 and restored._run_config.checkpoint_config == cc)
        res_c = restored.fit()
        hist = res_c.metrics_history
        listed_c = stored("a")
        checks["c_state_from_trainer_pkl"] = state
        checks["c_resumed_past_step_12"] = [m["step"] for m in hist] == list(
            range(TRAINER_STEPS + 1, n_all + 1))
        checks["c_losses_bit_equal"] = [m["loss"] for m in hist] == direct[
            TRAINER_STEPS:]
        checks["c_retention"] = len(listed_c) <= TRAINER_KEEP
        out["c"] = {"steps": [m["step"] for m in hist],
                    "losses": [m["loss"] for m in hist],
                    "direct_losses": direct[TRAINER_STEPS:],
                    "stored": len(listed_c)}

        # (e) two ranks on the card.
        rng = np.random.default_rng(SEED + 15)
        x = rng.standard_normal((TRAINER_MLP_ROWS, cfg.d_model)).astype(
            np.float32)
        w = (rng.standard_normal((cfg.d_model, cfg.d_model))
             / np.sqrt(cfg.d_model)).astype(np.float32)
        y = np.tanh(x @ w)
        out["e"] = e = _two_ranks(dev, cfg, lambda: data.from_columns(
            {"x": x, "y": y}, parallelism=4))
        checks["e_ranks_bit_equal"] = e["ranks_bit_equal"]
        checks["e_matches_one_worker"] = (
            e["max_abs_diff_vs_one_worker"] <= TRAINER_MLP_TOL)
        checks["e_loss_falls"] = e["losses"][-1] < e["losses"][0]
    finally:
        MemoryFilesystem.clear()
        rt.shutdown()
        for d in fetched + [tmp_root]:
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    result = {"phase": "trainer", "config": {
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "dtype": _dtype_name(cfg.dtype), "batch": [TRAIN_BATCH, TRAIN_LEN],
        "steps": n_all, "checkpoint_every": TRAINER_CKPT_EVERY,
        "num_to_keep": TRAINER_KEEP, "storage": TRAINER_ROOT},
        "checks": checks, **out, "phase_s": time.perf_counter() - t_phase,
        "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14 (trainer) failed {failed}")
    return result


# ------------------------------------------------------- phase 15: observe
@contextlib.contextmanager
def _observe_env(armed):
    """OBSERVE_ENV unset for the block, or RAY_TPU_TRACE and
    RAY_TPU_FLIGHT set to 1 when ``armed``; the process's values come
    back after it."""
    kept = {k: os.environ.get(k) for k in OBSERVE_ENV}
    for k in OBSERVE_ENV:
        os.environ.pop(k, None)
    if armed:
        os.environ["RAY_TPU_TRACE"] = os.environ["RAY_TPU_FLIGHT"] = "1"
    try:
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _poll_until(cond, bound=OBSERVE_POLL_S):
    deadline = time.monotonic() + bound
    out = cond()
    while not out and time.monotonic() < deadline:
        time.sleep(0.01)
        out = cond()
    return out


def _new_request_traces(before, roots, n):
    """The traces rooted at a span named in ``roots`` that appeared since
    ``before`` (a set of trace ids), once ``n`` of them hold their
    engine's llm.decode and their replica call's task.exec (both land a
    beat after the stream's last item); bounded by OBSERVE_POLL_S."""
    from ray_tpu_torch._private import tracing

    def ready():
        index = tracing.trace_index()
        tids = [t for t, r in index.items()
                if t not in before and r["root"] in roots]
        done = [t for t in tids if {"llm.decode", "task.exec"} <= {
            s["name"] for s in tracing.local_spans(t)}]
        return tids if len(done) >= n else None

    tids = _poll_until(ready)
    if tids is None:
        raise AssertionError(f"no {n} complete {roots} traces within "
                             f"{OBSERVE_POLL_S}s")
    return tids


def _check_request_trace(tid, http=False, kv_ship=None):
    """One served request's trace (phase 15 (b)): exactly the reference's
    spans (http.request for HTTP requests, serve.request, the replica
    call's task.queue and task.exec, the engine's llm.queue, llm.prefill,
    llm.kv_ship for an adopted sequence, llm.decode), each parented as in
    the reference, none of the engine's starting before serve.request,
    one first_token event inside llm.decode (1 us of slack for the float
    rounding of two wall-clock sums), no error; an adopted sequence's
    kv_ship tags equal ``kv_ship`` (blocks, bytes). Returns each span's
    seconds (host clock: a span around device work times its enqueue and
    the engine's host syncs) and the span count."""
    from ray_tpu_torch.util import state

    summary = state.trace_summary(tid)
    spans = summary["spans"]
    by = {}
    for sp in spans:
        by.setdefault(sp["name"], []).append(sp)
    want = ["serve.request", "task.queue", "task.exec", "llm.queue",
            "llm.prefill", "llm.decode"]
    if http:
        want.append("http.request")
    if kv_ship is not None:
        want.append("llm.kv_ship")
    names = sorted(sp["name"] for sp in spans)
    if names != sorted(want) or summary["errors"]:
        raise AssertionError(f"trace {tid}: spans {names}, errors "
                             f"{summary['errors']}")
    req = by["serve.request"][0]
    if req["parent_id"] != (by["http.request"][0]["span_id"] if http
                            else ""):
        raise AssertionError(f"trace {tid}: serve.request's parent")
    for name in want:
        if name in ("serve.request", "http.request"):
            continue
        sp = by[name][0]
        if sp["parent_id"] != req["span_id"] or sp["t0"] < req["t0"]:
            raise AssertionError(f"trace {tid}: {name} not under "
                                 f"serve.request")
    dec = by["llm.decode"][0]
    events = dec["events"]
    if (len(events) != 1 or events[0][1] != "first_token"
            or not dec["t0"] <= events[0][0]
            <= dec["t0"] + dec["dur"] + 1e-6):
        raise AssertionError(f"trace {tid}: llm.decode events {events}")
    if kv_ship is not None:
        tags = by["llm.kv_ship"][0]["tags"]
        if (int(tags["blocks"]), int(tags["bytes"])) != kv_ship:
            raise AssertionError(f"trace {tid}: kv_ship tags {tags}, "
                                 f"export_blocks shipped {kv_ship}")
    return {n: by[n][0]["dur"] for n in want}, len(spans)


def _ms(seconds):
    return [x * 1e3 for x in seconds]


def _span_p50_ms(rows):
    return {n: _p50([r[n] for r in rows]) * 1e3 for n in sorted(rows[0])}


def _task_readings(traced):
    """us per trivial task, SERVE_SYNC_CALLS one get at a time and
    SERVE_TASKS submitted at once (after a warm-up); ``traced``: each
    run under a span, with its tasks' task.queue and task.exec p50 (the
    bridge's spans: pending -> RUNNING, RUNNING -> FINISHED; host
    clock)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import tracing

    @rt.remote
    def noop(i):
        return i

    rt.get([noop.remote(i) for i in range(100)], timeout=SERVE_POLL_S)
    out = {}
    for kind, n in (("sync", SERVE_SYNC_CALLS), ("bulk", SERVE_TASKS)):
        with tracing.start_span(f"smoke.tasks.{kind}") as span:
            t0 = time.perf_counter()
            if kind == "sync":
                got = [rt.get(noop.remote(i), timeout=SERVE_POLL_S)
                       for i in range(n)]
            else:
                got = rt.get([noop.remote(i) for i in range(n)],
                             timeout=SERVE_POLL_S * 4)
            wall = time.perf_counter() - t0
        if got != list(range(n)):
            raise AssertionError(f"trivial tasks ({kind}): wrong results")
        out[kind] = {"tasks": n, "us_per_task": wall / n * 1e6}
        if not traced:
            continue

        def spans():
            ss = tracing.local_spans(span.ctx.trace_id)
            return ss if sum(x["name"] == "task.exec" for x in ss) >= n \
                else None

        ss = _poll_until(spans) or []
        for name in ("task.queue", "task.exec"):
            durs = [x["dur"] for x in ss if x["name"] == name]
            if len(durs) != n:
                raise AssertionError(f"{kind}: {len(durs)} {name} spans "
                                     f"for {n} tasks")
            out[kind][f"{name}_us_p50"] = _p50(durs) * 1e6
    return out


def _observe_app(cfg, dev, name="llm"):
    from ray_tpu_torch.llm import EngineConfig, build_llm_app

    return build_llm_app(EngineConfig(
        model=cfg, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
        device=str(dev)), name=name)


def _observe_inert(cfg, dev, prompts, want, new_tokens, tokens, direct):
    """Phase 15 (a): with OBSERVE_ENV unset, a task, an actor call, the
    served prompts and the flagship's steps as actor calls leave the
    tracer and the recorder off, zero spans, no _trace key in the request
    dicts the replica sees, the engine's tokens, the direct call's losses
    and 4 / 4 / 4 launches a step. Returns the served streams, the
    request keys and the actor's step seconds."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import flight, tracing
    from ray_tpu_torch.llm import api as llm_api

    seen = []
    call = llm_api.LLMServer.__call__

    def recording(self, request):
        seen.append(dict(request) if isinstance(request, dict) else request)
        return call(self, request)

    rt.init(num_cpus=4)
    try:
        @rt.remote
        def echo(x):
            return x

        @rt.remote
        class Echo:
            def echo(self, x):
                return x

        actor = Echo.remote()
        values = (rt.get(echo.remote(1), timeout=SERVE_POLL_S),
                  rt.get(actor.echo.remote(2), timeout=SERVE_POLL_S))
        tasks = _task_readings(traced=False)
        with _patched(llm_api.LLMServer, "__call__", recording):
            handle = serve.run(_observe_app(cfg, dev))
            served = _served_streams(handle, prompts, new_tokens)
        losses, counts, plain, step_s, trainer, _ = _actor_steps(
            cfg, dev, tokens)
        rt.kill(trainer)
        _check_actor_steps("unarmed", direct, losses, counts, plain,
                           cfg.n_layers)
        keys = sorted({k for r in seen if isinstance(r, dict) for k in r})
        armed = (tracing.tracer(), flight.recorder())
        spans = len(tracing.local_spans())
    finally:
        serve.shutdown()
        rt.shutdown()
    _must_equal("unarmed served", [s[0] for s in served], want)
    if (values != (1, 2) or armed != (None, None) or spans
            or "_trace" in keys or len(seen) != len(prompts)):
        raise AssertionError(f"unarmed: values {values}, tracer/recorder "
                             f"{armed}, spans {spans}, request keys {keys}")
    return served, keys, step_s, tasks


def _observe_served(cfg, dev, prompts, want, new_tokens):
    """Phase 15 (b): the flagship served through the handle, the HTTP
    proxy and a disaggregated prefill/decode pair, one request at a time,
    each request's trace checked (_check_request_trace). Returns the
    readings."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.llm import (
        DisaggHandle,
        EngineConfig,
        build_disagg_llm_app,
    )

    handle = serve.run(_observe_app(cfg, dev))
    proxy = serve.start_proxy(port=0)
    runs = {"handle": [], "http": [], "disagg": []}
    span_s = {"handle": [], "http": [], "disagg_prefill": [],
              "disagg_decode": []}
    n_spans = {k: [] for k in span_s}
    for p in prompts:
        for kind, root, items in (
                ("handle", "serve.request",
                 lambda: handle.options(stream=True).remote(
                     {"prompt": p, "max_new_tokens": new_tokens})),
                ("http", "http.request",
                 lambda: _http_tokens(proxy, "llm", p, new_tokens))):
            before = set(tracing.trace_index())
            runs[kind].append(_timed_stream(items))
            tids = _new_request_traces(before, (root,), 1)
            if len(tids) != 1:
                raise AssertionError(f"{kind}: {len(tids)} traces for one "
                                     f"request")
            secs, count = _check_request_trace(tids[0],
                                               http=kind == "http")
            span_s[kind].append(secs)
            n_spans[kind].append(count)
    for kind in ("handle", "http"):
        _must_equal(f"traced {kind}", [r[0] for r in runs[kind]], want)
    papp, dapp = build_disagg_llm_app(EngineConfig(
        model=cfg, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
        device=str(dev)))
    serve.run(papp, name="prefill")
    serve.run(dapp, name="decode")
    pair = DisaggHandle.from_deployments()
    ph = serve.get_deployment_handle("llm-prefill")
    for p in prompts:
        st = _prefill_stats(ph)
        before = set(tracing.trace_index())
        runs["disagg"].append(_timed_stream(lambda: pair.stream(
            {"prompt": p, "max_new_tokens": new_tokens})))
        tids = _new_request_traces(before, ("serve.request",), 2)
        after = _prefill_stats(ph)
        shipped = (after["kv_blocks_published"] - st["kv_blocks_published"],
                   after["kv_bytes_published"] - st["kv_bytes_published"])
        hops = {("llm.kv_ship" in {s["name"] for s in
                                   tracing.local_spans(t)}): t
                for t in tids}
        if len(tids) != 2 or set(hops) != {True, False}:
            raise AssertionError(f"disagg: traces {tids}")
        secs, count = _check_request_trace(hops[False])
        span_s["disagg_prefill"].append(secs)
        n_spans["disagg_prefill"].append(count)
        secs, count = _check_request_trace(hops[True], kv_ship=shipped)
        span_s["disagg_decode"].append(secs)
        n_spans["disagg_decode"].append(count)
    _must_equal("traced disagg", [r[0] for r in runs["disagg"]], want)
    if (pair.paired, pair.prefill_fallbacks) != (len(prompts), 0):
        raise AssertionError(f"disagg: paired {pair.paired}, prefill "
                             f"fallbacks {pair.prefill_fallbacks}")
    return runs, {
        "requests_each": len(prompts),
        "traces_checked": sum(len(v) for v in span_s.values()),
        "spans_per_request": {k: v[0] if len(set(v)) == 1 else v
                              for k, v in n_spans.items()},
        "span_p50_ms": {k: _span_p50_ms(v) for k, v in span_s.items()},
        # The prefill hop's replica call outside its engine spans: the
        # export's gather and host copy, and the put of the payload.
        "prefill_hop_outside_engine_ms_p50": _p50([
            r["task.exec"] - sum(v for n, v in r.items()
                                 if n.startswith("llm."))
            for r in span_s["disagg_prefill"]]) * 1e3}


def _actor_steps(cfg, dev, tokens, trace_dir=None):
    """The flagship's bf16 make_train_step as an actor method,
    OBSERVE_TRAIN_STEPS calls on the seeded batches, each call's launch
    counts and plain routes read around it. Phase 15 (c) (``trace_dir``
    given): the calls inside the span smoke.train, the OBSERVE_PROFILED
    ones inside profile_trace(trace_dir); (a): none of that. Returns the
    losses, counts, plain routes and step seconds, the actor, and the
    span's context (None untraced)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.util import profiling

    @rt.remote
    class SmokeTrainer:
        def __init__(self):
            from ray_tpu_torch import models as tm

            self.step_fn = tm.make_train_step(
                cfg, tm.init_params(cfg, SEED, device=dev))

        def step(self, batch_tokens):
            batch = torch.tensor(batch_tokens, device=dev)
            return self.step_fn(batch[:, :-1], batch[:, 1:]).item()

    fa = _flash_module()
    trainer = SmokeTrainer.remote()
    losses, counts, plain, step_s = [], [], [], []
    span = tracing.start_span("smoke.train") if trace_dir else \
        contextlib.nullcontext()
    with span as ctx, contextlib.ExitStack() as profiled:
        for i in range(OBSERVE_TRAIN_STEPS):
            if trace_dir and i + 1 == OBSERVE_PROFILED[0]:
                profiled.enter_context(
                    profiling.profile_trace(trace_dir, device=dev))
            _zero_counts()
            plain0 = fa.plain_routes
            t0 = time.perf_counter()
            losses.append(rt.get(trainer.step.remote(
                tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]),
                timeout=SERVE_POLL_S * 4))
            step_s.append(time.perf_counter() - t0)
            counts.append(_counts())
            plain.append(fa.plain_routes - plain0)
            if trace_dir and i + 1 == OBSERVE_PROFILED[-1]:
                torch.cuda.synchronize()
                profiled.close()
    return (losses, counts, plain, step_s, trainer,
            ctx.ctx if ctx is not None else None)


def _check_actor_steps(name, direct, losses, counts, plain, L):
    if losses != direct:
        raise AssertionError(f"{name} actor losses {losses} differ from "
                             f"the direct call's {direct}")
    if any(c != _want_counts("wgmma", L, L) for c in counts) or any(plain):
        raise AssertionError(f"{name} actor steps launched {counts}, "
                             f"plain routes {plain}")


def _observe_timeline(span):
    """Phase 15 (c)'s timelines: timeline() holds each SmokeTrainer.step
    call, RUNNING through to FINISHED; timeline(trace_id=...) holds each
    call's task.queue and task.exec under smoke.train (``span``). Both
    land a beat after get() returns: polled, bounded."""
    import ray_tpu_torch as rt

    def calls():
        ev = [e for e in rt.timeline() if e["name"] == "SmokeTrainer.step"]
        return ev if len(ev) >= OBSERVE_TRAIN_STEPS else None

    def under():
        ev = [e for e in rt.timeline(trace_id=span.trace_id)
              if e["name"] in ("task.queue", "task.exec")
              and e["args"]["parent_id"] == span.span_id
              and e["args"].get("task") == "SmokeTrainer.step"]
        return ev if len(ev) >= 2 * OBSERVE_TRAIN_STEPS else None

    got_calls, got_under = _poll_until(calls) or [], _poll_until(under) or []
    if (len(got_calls) != OBSERVE_TRAIN_STEPS
            or any(e["args"]["state"] != "FINISHED" for e in got_calls)
            or len(got_under) != 2 * OBSERVE_TRAIN_STEPS):
        raise AssertionError(
            f"timeline: actor calls {[e['args'] for e in got_calls]}, "
            f"{len(got_under)} task spans under smoke.train")
    return got_calls, got_under


def _trace_device_ms(trace_dir, steps):
    """Device time per step from profile_trace's Chrome trace: every
    kernel event's duration, and the flash kernels' event counts."""
    from ray_tpu_torch.util import profiling

    (path,) = profiling.trace_files(trace_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return {"device_ms_per_step": "not measured: the trace holds no "
                                      "kernel events",
                "trace_bytes": os.path.getsize(path)}
    return {"device_ms_per_step":
            sum(e.get("dur", 0.0) for e in kernels) / 1e3 / steps,
            "kernel_events_per_step": len(kernels) / steps,
            "flash_kernel_events": {
                c: sum(name in e.get("name", "") for e in kernels)
                for c, name in TRACE_KERNELS.items()},
            "trace_bytes": os.path.getsize(path)}


def _prometheus_samples(text):
    """{name{labels}: value} of Prometheus text; raises on a line that
    is not a comment or a sample."""
    pat = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        if m is None:
            raise AssertionError(f"not Prometheus text: {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def _observe_dump(dump_dir, trace_dir, first_engine_id):
    """Phase 15 (d): debug_dump()'s incident directory, its sections (the
    runtime, Serve, one llm.engine-<id> per engine built since the
    recorder was armed), its artifacts, stacks and metrics. Returns
    the readings."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import live_engines

    t0 = time.perf_counter()
    incident = rt.debug_dump(dump_dir)
    dump_s = time.perf_counter() - t0
    files = sorted(os.listdir(incident))
    with open(os.path.join(incident, "manifest.json")) as f:
        manifest = json.load(f)
    path = os.path.join(incident, "driver.json")
    with open(path) as f:
        bundle = json.load(f)
    sections = bundle["sections"]
    engines = {f"llm.engine-{e.engine_id}" for e in live_engines()
               if e.engine_id >= first_engine_id}
    engine_sections = {k for k in sections if k.startswith("llm.engine-")}
    samples = _prometheus_samples(bundle["metrics"])
    spans_recorded = samples.get("ray_tpu_trace_spans_recorded", 0.0)
    broken = [k for k, v in sections.items()
              if isinstance(v, dict) and ("error" in v or "gone" in v)]
    actor_stacks = [k for k in bundle["stacks"]
                    if k.startswith("actor-SmokeTrainer")]
    ok = (files == ["driver.json", "manifest.json"]
          and set(manifest["sources"]) == {"driver"}
          and {"runtime", "serve"} <= set(sections)
          and engine_sections == engines and len(engines) == 3
          and not broken
          and os.path.abspath(trace_dir) in bundle["artifacts"]
          and actor_stacks and spans_recorded > 0)
    out = {"files": files, "sections": sorted(sections),
           "engines_since_armed": sorted(engines),
           "artifacts": bundle["artifacts"],
           "actor_stacks": actor_stacks,
           "trace_spans_recorded": spans_recorded,
           "metric_samples": len(samples),
           "debug_dump_s": dump_s, "bundle_bytes": os.path.getsize(path)}
    if not ok:
        raise AssertionError(f"debug_dump: {out}, sections in error "
                             f"{broken}")
    return out


def _observe_watchdog(incident_dir):
    """Phase 15 (e): a lock noted held past OBSERVE_LOCK_S fires the
    lock-hold watchdog exactly once and writes one auto dump; two more
    watchdog periods add no fire. Returns the readings."""
    from ray_tpu_torch._private import flight
    from ray_tpu_torch._private.config import GlobalConfig

    rec = flight.recorder()

    def lock_fires():
        return sum(k == "lock-hold" for _, k, _ in list(rec.watchdog_last))

    def dumps():
        return sorted(f for f in os.listdir(incident_dir)
                      if "-lock-hold-" in f and f.endswith(".json"))

    GlobalConfig.set("flight_lock_watchdog_s", OBSERVE_LOCK_S)
    GlobalConfig.set("flight_dump_min_interval_s", 0.0)
    fires0, held, release = lock_fires(), threading.Event(), \
        threading.Event()

    def holder():
        flight.note_lock_acquired("smoke.planted_lock")
        held.set()
        release.wait(OBSERVE_POLL_S)
        flight.note_lock_released("smoke.planted_lock")

    t = threading.Thread(target=holder, name="smoke-lock-holder",
                         daemon=True)
    t.start()
    try:
        held.wait(OBSERVE_POLL_S)
        t0 = time.monotonic()
        fired = _poll_until(lambda: dumps() and lock_fires() > fires0)
        fire_s = time.monotonic() - t0
        time.sleep(2 * rec._wd_period + 0.1)
    finally:
        release.set()
        t.join(OBSERVE_POLL_S)
        GlobalConfig.reset()
    out = {"lock_hold_fires": lock_fires() - fires0,
           "auto_dumps": len(dumps()), "fire_after_s": fire_s,
           "bound_s": OBSERVE_LOCK_S, "watchdog_period_s": rec._wd_period}
    if not fired or out["lock_hold_fires"] != 1 or out["auto_dumps"] != 1:
        raise AssertionError(f"the lock-hold watchdog: {out}")
    return out


def phase_observe(dev, card, cfg, lens, new_tokens):
    """Phase 15 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import flight, tracing
    from ray_tpu_torch.llm import live_engines

    L = cfg.n_layers
    prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                       cfg.vocab_size)
    want = [d[0] for d in _engine_streams(cfg, dev, prompts, new_tokens)]
    tokens = np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, (OBSERVE_TRAIN_STEPS * TRAIN_BATCH,
                            TRAIN_LEN + 1))
    direct, direct_s, direct_counts, direct_plain = _trainer_direct(
        cfg, dev, tokens, OBSERVE_TRAIN_STEPS)
    if (direct_counts != _want_counts("wgmma", OBSERVE_TRAIN_STEPS * L,
                                      OBSERVE_TRAIN_STEPS * L)
            or direct_plain):
        raise AssertionError(f"the direct steps launched {direct_counts}, "
                             f"plain routes {direct_plain}")
    rt.shutdown()
    with tempfile.TemporaryDirectory() as root:
        with _observe_env(armed=False):
            inert, request_keys, inert_step_s, inert_tasks = \
                _observe_inert(cfg, dev, prompts, want, new_tokens, tokens,
                               direct)
        with _observe_env(armed=True):
            first_engine = max([e.engine_id for e in live_engines()],
                               default=0) + 1
            rt.init(num_cpus=4)
            try:
                if tracing.tracer() is None or flight.recorder() is None:
                    raise AssertionError("init() did not arm the tracer "
                                         "and the recorder")
                incidents = os.path.join(root, "incidents")
                os.makedirs(incidents)
                flight.recorder().dump_dir = incidents
                runs, served = _observe_served(cfg, dev, prompts, want,
                                               new_tokens)
                tasks = _task_readings(traced=True)
                trace_dir = os.path.join(root, "trace")
                losses, counts, plain, step_s, trainer, span = \
                    _actor_steps(cfg, dev, tokens, trace_dir)
                _check_actor_steps("traced", direct, losses, counts, plain,
                                   L)
                calls, under = _observe_timeline(span)
                spans_train = len(tracing.local_spans(span.trace_id))
                dump = _observe_dump(os.path.join(root, "dumps"),
                                     trace_dir, first_engine)
                device = _trace_device_ms(trace_dir, len(OBSERVE_PROFILED))
                watchdog = _observe_watchdog(incidents)
                rt.kill(trainer)
            finally:
                serve.shutdown()
                rt.shutdown()
        left = (tracing.tracer(), flight.recorder(),
                [t.name for t in threading.enumerate()
                 if t.name.startswith("ray_tpu_flight")])
    if left != (None, None, []):
        raise AssertionError(f"shutdown left the tracer, the recorder or "
                             f"its threads: {left}")

    def readings(rs):
        return {"ttft_p50_s": _p50([r[1] for r in rs]),
                "token_gap_p50_s": _p50([g for r in rs for g in r[2]])}

    skip = {0} | {i - 1 for i in OBSERVE_PROFILED}
    out = {"phase": "observe",
           "inert": {"tracer": None, "recorder": None, "spans": 0,
                     "request_keys": request_keys, "equals_engine": True},
           "served": {**served, "equals_engine": True,
                      "unarmed_handle": readings(inert),
                      **{k: readings(v) for k, v in runs.items()}},
           "train": {"steps": OBSERVE_TRAIN_STEPS,
                     "losses_equal_direct": True,
                     "launches_per_step": counts[0],
                     "plain_routes": sum(plain),
                     "timeline_actor_calls_finished": len(calls),
                     "spans_under_smoke_train": len(under),
                     "spans_per_step": spans_train / OBSERVE_TRAIN_STEPS,
                     "step_ms_p50_unarmed_direct":
                         _p50(direct_s[1:]) * 1e3,
                     "step_ms_p50_unarmed_actor":
                         _p50(inert_step_s[1:]) * 1e3,
                     "step_ms_p50_traced_actor": _p50(
                         [s for i, s in enumerate(step_s)
                          if i not in skip]) * 1e3,
                     "step_ms": {"unarmed_direct": _ms(direct_s),
                                 "unarmed_actor": _ms(inert_step_s),
                                 "traced_actor": _ms(step_s)},
                     "profiled_steps": list(OBSERVE_PROFILED),
                     "profiled": device},
           "tasks": {"unarmed": inert_tasks, "traced": tasks},
           "debug_dump": dump, "watchdog": watchdog, "card": card}
    emit(out)
    return out


# ---------------------------------------------------------- phase 16: data
def _stack_tokens(batch):
    """read_tfrecords gives a multi-element feature as an object column of
    per-row arrays (the reference's column semantics); the trainer feeds
    it as one [rows, 2049] int64 array."""
    return {"tokens": np.stack(list(batch["tokens"])).astype(np.int64)}


def _tokens_of(ds):
    """Every row of ``ds``'s tokens column, in the dataset's order."""
    return np.concatenate([np.stack(list(b["tokens"])) for b in
                           ds.iter_blocks()]).astype(np.int64)


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _data_loop(config):
    """Phase 16 (b)'s train_loop_per_worker: the flagship's bf16 AdamW
    steps on the worker's shard of the shuffled TFRecord dataset,
    reporting each step's loss, its time and the rows it took."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import train

    cfg, dev = config["cfg"], torch.device(config["device"])
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    batches = train.get_dataset_shard("train").iter_torch_batches(
        batch_size=TRAIN_BATCH, device=dev)
    for i in range(1, config["steps"] + 1):
        tokens = next(batches)["tokens"]
        t0 = time.perf_counter()
        loss = step(tokens[:, :-1], tokens[:, 1:]).item()
        train.report({"step": i, "loss": loss,
                      "step_s": time.perf_counter() - t0,
                      "rows": tokens.cpu().numpy()})


def _data_round_trips(data, tokens, root):
    """Phase 16 (a): the token table through TFRecords, .npy and one
    binary file, each back bit for bit; a flipped payload byte raises
    under check_integrity."""
    checks, out = {}, {}
    tfr = os.path.join(root, "tfr")
    src = data.from_columns({"tokens": tokens}, parallelism=4)
    t0 = time.perf_counter()
    src.write_tfrecords(tfr)
    write_s = time.perf_counter() - t0
    nbytes = _dir_bytes(tfr)
    t0 = time.perf_counter()
    back = _tokens_of(data.read_tfrecords(tfr))
    read_s = time.perf_counter() - t0
    checks["a_tfrecords_bit_equal"] = (back.shape == tokens.shape
                                       and np.array_equal(back, tokens))
    npy = os.path.join(root, "npy")
    os.makedirs(npy)
    np.save(os.path.join(npy, "tokens.npy"), tokens)
    got = [b["data"] for b in data.read_numpy(npy).iter_blocks()]
    checks["a_numpy_bit_equal"] = (len(got) == 1 and got[0].dtype
                                   == tokens.dtype
                                   and np.array_equal(got[0], tokens))
    first = sorted(os.listdir(tfr))[0]
    with open(os.path.join(tfr, first), "rb") as fh:
        raw = fh.read()
    rows = data.read_binary_files(os.path.join(tfr, first)).take_all()
    checks["a_binary_bit_equal"] = (len(rows) == 1
                                    and rows[0]["bytes"] == raw)
    bad = os.path.join(root, "bad")
    os.makedirs(bad)
    flipped = bytearray(raw)
    flipped[12] ^= 0xFF   # the first payload byte of the first record
    with open(os.path.join(bad, first), "wb") as fh:
        fh.write(bytes(flipped))
    try:
        data.read_tfrecords(bad, check_integrity=True).materialize()
        err = "no error"
    except ValueError as exc:   # the read task's error, its last line
        err = str(exc).strip().splitlines()[-1]
    checks["a_flipped_byte_raises"] = "data CRC" in err
    out["a"] = {"rows": int(tokens.shape[0]), "row_len": int(tokens.shape[1]),
                "files": len(os.listdir(tfr)), "tfrecord_bytes": nbytes,
                "write_tfrecords_s": write_s, "read_tfrecords_s": read_s,
                "write_MBps": nbytes / write_s / 1e6,
                "read_MBps": nbytes / read_s / 1e6,
                "flipped_byte_error": err}
    return tfr, checks, out


def _data_trainer(data, cfg, dev, tokens, tfr):
    """Phase 16 (b): the flagship trained through DataParallelTrainer from
    the shuffled TFRecord dataset, against make_train_step called
    directly on the rows the worker took."""
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    fa, L, steps = _flash_module(), cfg.n_layers, DATA_TRAIN_STEPS
    checks = {}
    ds = data.read_tfrecords(tfr).map_batches(
        _stack_tokens, batch_size=None).random_shuffle(seed=DATA_SHUFFLE_SEED)
    first, second = _tokens_of(ds), _tokens_of(ds)
    where = {r.tobytes(): i for i, r in enumerate(tokens)}
    perm = [where.get(r.tobytes(), -1) for r in first]
    checks["b_two_executions_same_order"] = np.array_equal(first, second)
    checks["b_shuffled_is_permutation"] = sorted(perm) == list(
        range(len(tokens)))
    _zero_counts()
    plain = fa.plain_routes
    res = DataParallelTrainer(
        _data_loop, train_loop_config={"cfg": cfg, "device": str(dev),
                                       "steps": steps},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": ds}).fit()
    counts, plain_t = _counts(), fa.plain_routes - plain
    hist = res.metrics_history
    taken = np.concatenate([m["rows"] for m in hist])
    direct, direct_s, direct_counts, direct_plain = _trainer_direct(
        cfg, dev, taken, steps)
    checks["b_worker_rows_in_shuffled_order"] = np.array_equal(
        taken, first[:len(taken)])
    checks["b_losses_bit_equal"] = [m["loss"] for m in hist] == direct
    want = _want_counts("wgmma", steps * L, steps * L)
    checks["b_launches_per_step"] = counts == want and direct_counts == want
    checks["b_plain_routes_0"] = plain_t == 0 and direct_plain == 0
    return checks, {
        "steps": len(hist), "shuffle_seed": DATA_SHUFFLE_SEED,
        "first_rows": perm[:8], "losses": [m["loss"] for m in hist],
        "direct_losses": direct,
        "launches_per_step": {k: v / steps for k, v in counts.items() if v},
        "plain_routes": plain_t,
        "step_ms_p50": _p50([m["step_s"] for m in hist[1:]]) * 1e3,
        "direct_step_ms_p50": _p50(direct_s[1:]) * 1e3}


def _data_all_to_all(data):
    """Phase 16 (c): shuffle, sort both ways, groupby with every
    aggregate, repartition and zip over DATA_ROWS rows in DATA_BLOCKS
    blocks, each against numpy on the same table."""
    rng = np.random.default_rng(SEED + 16)
    key = rng.integers(0, DATA_KEY_RANGE, DATA_ROWS).astype(np.int64)
    table = {"key": key, "bucket": key % DATA_BUCKETS,
             "x": rng.standard_normal(DATA_ROWS).astype(np.float32)}
    ds = data.from_columns(table, parallelism=DATA_BLOCKS)
    checks, secs = {}, {}

    def columns(d, name):
        t0 = time.perf_counter()
        blocks = [b for b in d.iter_blocks() if b]
        secs[name] = time.perf_counter() - t0
        return {k: np.concatenate([b[k] for b in blocks]) for k in table}

    def rows_sorted(cols):
        order = np.lexsort((cols["x"], cols["key"]))
        return {k: v[order] for k, v in cols.items()}

    shuffled = columns(ds.random_shuffle(seed=DATA_SHUFFLE_SEED),
                       "random_shuffle")
    checks["c_shuffle_is_permutation"] = all(
        np.array_equal(a, b) for a, b in zip(
            rows_sorted(shuffled).values(), rows_sorted(table).values()))
    checks["c_shuffle_moved_rows"] = not np.array_equal(shuffled["key"], key)
    order = np.argsort(key, kind="stable")
    for desc in (False, True):
        want_order = order[::-1] if desc else order
        got = columns(ds.sort("key", descending=desc),
                      "sort_descending" if desc else "sort")
        checks[f"c_sort{'_descending' if desc else ''}_equals_argsort"] = \
            all(np.array_equal(got[k], table[k][want_order]) for k in table)
    t0 = time.perf_counter()
    agg = [b for b in ds.groupby("bucket").aggregate(
        data.Count(), data.Sum("x"), data.Mean("x"), data.Min("x"),
        data.Max("x"), data.Std("x")).iter_blocks() if b]
    secs["groupby"] = time.perf_counter() - t0
    agg = {k: np.concatenate([b[k] for b in agg]) for k in agg[0]}
    want = {"count()": [], "sum(x)": [], "mean(x)": [], "min(x)": [],
            "max(x)": [], "std(x)": []}
    for g in range(DATA_BUCKETS):
        x = table["x"][table["bucket"] == g]
        for name, v in (("count()", len(x)), ("sum(x)", float(np.sum(x))),
                        ("mean(x)", float(np.sum(x)) / len(x)),
                        ("min(x)", float(x.min())), ("max(x)", float(x.max())),
                        ("std(x)", float(np.std(x)))):
            want[name].append(v)
    agg_err = max(float(np.max(np.abs(agg[k] - np.asarray(v))
                                / np.maximum(np.abs(np.asarray(v)), 1e-30)))
                  for k, v in want.items())
    checks["c_groupby_equals_numpy"] = (
        np.array_equal(agg["bucket"], np.arange(DATA_BUCKETS))
        and np.array_equal(agg["count()"], want["count()"])
        and agg_err <= DATA_AGG_RTOL)
    rep = ds.repartition(DATA_REPARTITION).materialize()
    got = columns(rep, "repartition")
    checks["c_repartition_keeps_rows"] = (
        rep.num_blocks() == DATA_REPARTITION
        and all(np.array_equal(got[k], table[k]) for k in table))
    left = data.from_columns({"key": key, "bucket": table["bucket"]},
                             parallelism=DATA_BLOCKS)
    zipped = columns(left.zip(data.from_columns(
        {"x": table["x"]}, parallelism=DATA_BLOCKS // 2)), "zip")
    checks["c_zip_lines_rows_up"] = all(
        np.array_equal(zipped[k], table[k]) for k in table)
    try:
        left.zip(data.from_columns({"x": table["x"][:-1]})).materialize()
        unequal = "no error"
    except ValueError as exc:
        unequal = type(exc).__name__
    checks["c_zip_unequal_value_error"] = unequal == "ValueError"
    return checks, {"rows": DATA_ROWS, "blocks": DATA_BLOCKS,
                    "table_MB": sum(v.nbytes for v in table.values()) / 1e6,
                    "seconds": secs, "groupby_max_rel_err": agg_err,
                    "groupby_rtol": DATA_AGG_RTOL,
                    "zip_unequal": unequal}


class _EagerProgram:
    """A GraphProgram that runs eagerly on the card: the graph's twin."""

    def __new__(cls, *args, **kwargs):
        from ray_tpu_torch.rl._graph import GraphProgram

        program = GraphProgram(*args, **kwargs)
        program.graph = False
        return program


def _data_offline_dqn(dev, root):
    """Phase 16 (d): an online DQN on CartPole at the reference's
    settings, its buffer through TFRecords, then a DQN trained offline
    from the files on the card; one offline iteration as a CUDA graph
    against the same iteration run eagerly."""
    from ray_tpu_torch import data, rl
    from ray_tpu_torch.rl import dqn as dqn_module
    from ray_tpu_torch.rl.ppo import clone_params, leaves

    checks = {}
    train_kw = dict(DATA_DQN_TRAIN)
    online = (rl.AlgorithmConfig("DQN", device=dev)
              .environment("CartPole-v1")
              .env_runners(num_envs_per_env_runner=DATA_DQN_ENVS[0],
                           rollout_fragment_length=DATA_DQN_ENVS[1])
              .training(min_buffer_size=DATA_DQN_MIN_BUFFER, **train_kw)
              .debugging(seed=SEED).build())
    t0 = time.perf_counter()
    for _ in range(DATA_DQN_ONLINE_ITERS):
        online.train()
    online_s = time.perf_counter() - t0
    online_eval = online.evaluate(num_episodes=5)["episode_return_mean"]
    buf = online.learner._buffer
    path = os.path.join(root, "transitions")
    t0 = time.perf_counter()
    rl.buffer_to_dataset(buf).write_tfrecords(path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = data.read_tfrecords(path).materialize()   # read once, used thrice
    read_s = time.perf_counter() - t0
    config = rl.DQNConfig(**train_kw)
    t0 = time.perf_counter()
    offline = rl.train_dqn_offline(
        online.env, ds, config=config,
        num_iterations=DATA_DQN_OFFLINE_ITERS, seed=DATA_DQN_SEED,
        device=dev)
    _sync(dev)
    offline_s = time.perf_counter() - t0
    checks["d_buffer_back_bit_equal"] = len(offline._buffer) == len(buf) \
        and all(np.array_equal(offline._buffer._store[k][:len(buf)],
                               v[:len(buf)]) for k, v in buf._store.items())
    online_params = clone_params(online.learner.params)
    online.learner.set_weights(offline.params)
    offline_eval = online.evaluate(num_episodes=5)["episode_return_mean"]
    online.learner.set_weights(online_params)
    checks["d_offline_reaches_0.6_of_online"] = (
        offline_eval >= DATA_DQN_PARITY * online_eval)
    checks["d_offline_graphed"] = offline._program is not None and \
        offline._program.graph == (dev.type == "cuda")
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(RL_TIMED):
        offline.train_from_buffer()
    _sync(dev)
    iteration_s = (time.perf_counter() - t0) / RL_TIMED
    # One offline iteration, graph against eager, from the same buffer,
    # parameters and numpy generator.
    graphed = rl.train_dqn_offline(online.env, ds, config=config,
                                   num_iterations=0, seed=DATA_DQN_SEED,
                                   device=dev)
    with _patched(dqn_module, "GraphProgram", _EagerProgram):
        eager = rl.train_dqn_offline(online.env, ds, config=config,
                                     num_iterations=0, seed=DATA_DQN_SEED,
                                     device=dev)
        loss_e = eager.train_from_buffer()
    loss_g = graphed.train_from_buffer()
    diff = max((a - b).abs().max().item() for a, b in zip(
        leaves(graphed.params), leaves(eager.params)))
    checks["d_graph_equals_eager"] = (diff <= RL_GRAPH_TOL
                                      and abs(loss_g - loss_e) <= RL_GRAPH_TOL)
    online.stop()
    return checks, {
        "env": "CartPole-v1", "num_envs": DATA_DQN_ENVS[0],
        "rollout_len": DATA_DQN_ENVS[1], **train_kw,
        "online_iterations": DATA_DQN_ONLINE_ITERS,
        "offline_iterations": DATA_DQN_OFFLINE_ITERS,
        "transitions": len(buf), "online_eval": online_eval,
        "offline_eval": offline_eval, "parity": DATA_DQN_PARITY,
        "online_s": online_s, "write_tfrecords_s": write_s,
        "read_tfrecords_s": read_s, "transitions_MB": _dir_bytes(path) / 1e6,
        "train_dqn_offline_s": offline_s,
        "offline_iteration_ms": iteration_s * 1e3,
        "graph_vs_eager": {"max_param_diff": diff, "loss": [loss_g, loss_e],
                           "tol": RL_GRAPH_TOL}}


def _data_custom_io(data):
    """Phase 16 (e): a custom Datasource round-trips rows; a custom
    Datasink sees start, its writes and complete, and on a planted
    failure on_write_failed before the error re-raises."""
    n = DATA_CUSTOM_ROWS

    class Squares(data.Datasource):
        def get_read_tasks(self, parallelism, **_):
            per = -(-n // parallelism)
            return [data.ReadTask(
                lambda lo=lo: [{"i": np.arange(lo, min(lo + per, n)),
                                "sq": np.arange(lo, min(lo + per, n)) ** 2}],
                num_rows=min(per, n - lo)) for lo in range(0, n, per)]

    class Sink(data.Datasink):
        def __init__(self, fail_at=None):
            self.events, self.rows, self.fail_at = [], 0, fail_at

        def on_write_start(self):
            self.events.append("start")

        def write(self, blocks):
            self.events.append("write")
            if self.fail_at is not None and len(self.events) - 1 == \
                    self.fail_at:
                raise RuntimeError("planted sink failure")
            wrote = sum(len(b["i"]) for b in blocks)
            self.rows += wrote
            return wrote

        def on_write_complete(self, results):
            self.events.append("complete")

        def on_write_failed(self, error):
            self.events.append(f"failed:{error}")

    ds = data.read_datasource(Squares(), parallelism=8)
    rows = ds.take_all()
    sink = Sink()
    results = ds.write_datasink(sink)
    bad = Sink(fail_at=3)
    try:
        ds.write_datasink(bad)
        raised = "no error"
    except RuntimeError as exc:
        raised = str(exc)
    checks = {
        "e_source_round_trips": [(int(r["i"]), int(r["sq"])) for r in rows]
        == [(i, i * i) for i in range(n)],
        "e_sink_lifecycle": (sink.events == ["start"] + ["write"] * 8
                             + ["complete"] and sum(results) == n
                             and sink.rows == n),
        "e_sink_failure_hook": (
            raised == "planted sink failure"
            and bad.events == ["start", "write", "write", "write",
                               "failed:planted sink failure"])}
    return checks, {"rows": n, "sink_events": sink.events,
                    "failed_sink_events": bad.events}


def phase_data(dev, card, cfg):
    """Phase 16 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    t_phase = time.perf_counter()
    tokens = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, ((TRAINER_STEPS + TRAINER_MORE) * TRAIN_BATCH,
                            TRAIN_LEN + 1))
    checks, out, part_s = {}, {}, {}
    rt.shutdown()
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rt.init(num_cpus=4)

    def part(name, fn, *args):
        t0 = time.perf_counter()
        c, o = fn(*args)
        part_s[name] = time.perf_counter() - t0
        checks.update(c)
        return o

    try:
        t0 = time.perf_counter()
        tfr, c, out_a = _data_round_trips(data, tokens, root)
        part_s["a"] = time.perf_counter() - t0
        checks.update(c)
        out.update(out_a)
        out["b"] = part("b", _data_trainer, data, cfg, dev, tokens, tfr)
        out["c"] = part("c", _data_all_to_all, data)
        out["d"] = part("d", _data_offline_dqn, dev, root)
        out["e"] = part("e", _data_custom_io, data)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    result = {"phase": "data", "checks": checks, **out, "part_s": part_s,
              "phase_s": time.perf_counter() - t_phase,
              "temporary_dirs_left": os.path.exists(root), "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed or result["temporary_dirs_left"]:
        raise AssertionError(f"phase 16 (data) failed {failed}")
    return result


# ---------------------------------------------------------- phase 17: tune
# Each trial's report-to-ack seconds (the trainables append; phase 17
# reads and clears).
_TUNE_ACKS = []


def _tune_trainable(config):
    """Phase 17 (a)'s trainable: the flagship's bf16 AdamW steps at
    ``config["lr"]`` from seed-0 parameters, one ``tune.report`` of the
    loss a step; at the steps of ``config["ckpt_at"]`` the report carries
    a flat checkpoint of the parameters, the AdamW state and the step,
    and the trial's previous checkpoint is removed once the controller
    has acked the new one."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import Checkpoint

    cfg, dev, tokens = config["cfg"], torch.device(config["device"]), \
        config["tokens"]
    t_start = time.perf_counter()
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params, lr=config["lr"])
    kept = None
    for i in range(1, TUNE_MAX_T + 1):
        batch = torch.tensor(tokens[(i - 1) * TRAIN_BATCH:i * TRAIN_BATCH],
                             device=dev)
        t0 = time.perf_counter()
        loss = step(batch[:, :-1], batch[:, 1:]).item()
        t1 = time.perf_counter()
        ckpt = None
        if i in config["ckpt_at"]:
            ckpt = Checkpoint.from_pytree(
                {"params": params, "opt": step.optimizer.state_dict(),
                 "step": i},
                os.path.join(config["tmp"], f"lr{config['lr']}_step{i}"))
        t2 = time.perf_counter()
        try:
            tune.report({"loss": loss, "step": i, "t_start": t_start,
                         "t0": t0, "t1": t1, "save_s": t2 - t1},
                        checkpoint=ckpt)
        finally:
            _TUNE_ACKS.append(time.perf_counter() - t2)
        if ckpt is not None:
            if kept is not None:
                shutil.rmtree(kept.path, ignore_errors=True)
            kept = ckpt


def _tune_direct(cfg, dev, tokens, lr, steps):
    """make_train_step at ``lr`` called directly for ``steps`` steps on
    the trials' batches: the losses, step seconds and parameters."""
    from ray_tpu_torch import models as tm

    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params, lr=lr)
    losses, step_s = [], []
    for i in range(steps):
        batch = torch.tensor(tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                             device=dev)
        t0 = time.perf_counter()
        losses.append(step(batch[:, :-1], batch[:, 1:]).item())
        step_s.append(time.perf_counter() - t0)
    return losses, step_s, params


def _overlapping(spans):
    """For each (trial, t0, t1) step interval, whether another trial's
    step interval overlaps it."""
    return [any(o != tid and a < t1 and t0 < b for o, a, b in spans)
            for tid, t0, t1 in spans]


def _tune_part(cfg, dev, tokens, tmp):
    """Phase 17 (a): the Tuner over the learning-rate grid under ASHA."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import tune

    fa, L = _flash_module(), cfg.n_layers
    checks = {}
    _tune_direct(cfg, dev, tokens, TUNE_LRS[0], 1)   # the kernels loaded
    torch.cuda.empty_cache()
    asha = tune.ASHAScheduler(metric="loss", mode="min", max_t=TUNE_MAX_T,
                              grace_period=TUNE_GRACE,
                              reduction_factor=TUNE_RF)
    ckpt_at = tuple(asha.rungs) + (TUNE_MAX_T,)
    _TUNE_ACKS.clear()
    _zero_counts()
    plain = fa.plain_routes
    t0 = time.perf_counter()
    grid = tune.Tuner(
        _tune_trainable,
        param_space={"lr": tune.grid_search(list(TUNE_LRS)), "cfg": cfg,
                     "device": str(dev), "tokens": tokens, "tmp": tmp,
                     "ckpt_at": ckpt_at},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            max_concurrent_trials=TUNE_CONCURRENT, scheduler=asha)).fit()
    fit_s = time.perf_counter() - t0
    counts, plain = _counts(), fa.plain_routes - plain
    trials = {r.config["lr"]: r for r in grid}
    ran = {lr: len(r.metrics_history) for lr, r in trials.items()}
    n_steps = sum(ran.values())
    best = grid.get_best_result()
    best_lr = best.config["lr"]
    # The direct loops: each learning rate for the steps its trial ran,
    # the best one step further.
    direct, ref_params = {}, None
    for lr in TUNE_LRS:
        losses, step_s, params = _tune_direct(
            cfg, dev, tokens, lr, ran[lr] + (lr == best_lr))
        direct[lr] = (losses, step_s)
        if lr == best_lr:
            ref_params = params
        del params
    checks["a_no_trial_error"] = all(r.error is None for r in grid)
    checks["a_losses_bit_equal_direct"] = all(
        [m["loss"] for m in r.metrics_history] == direct[lr][0][:ran[lr]]
        for lr, r in trials.items())
    checks["a_asha_cut_a_trial"] = min(ran.values()) < TUNE_MAX_T
    checks["a_last_report_has_checkpoint"] = all(
        r.checkpoint is not None and ran[lr] in ckpt_at
        for lr, r in trials.items())
    final = {lr: direct[lr][0][ran[lr] - 1] for lr in TUNE_LRS}
    checks["a_best_is_lowest_final_loss"] = (
        best.metrics["loss"] == min(final.values())
        and final[best_lr] == min(final.values()))
    checks["a_launches_per_step"] = counts == _want_counts(
        "wgmma", n_steps * L, n_steps * L)
    checks["a_plain_routes_0"] = plain == 0
    # The best trial's checkpoint resumes one more step, bit for bit.
    n = ran[best_lr]
    tree = best.checkpoint.to_pytree(device=dev)
    checks["a_checkpoint_step"] = tree["step"] == n
    params = tm.init_params(cfg, SEED, device=dev)
    with torch.no_grad():
        src = dict(_named_leaves(tree["params"]))
        for name, t in _named_leaves(params):
            t.copy_(src[name])
    step = tm.make_train_step(cfg, params, lr=best_lr)
    step.optimizer.load_state_dict(tree["opt"])
    del tree, src
    batch = torch.tensor(tokens[n * TRAIN_BATCH:(n + 1) * TRAIN_BATCH],
                         device=dev)
    resumed = step(batch[:, :-1], batch[:, 1:]).item()
    checks["a_resumed_step_bit_equal"] = (
        resumed == direct[best_lr][0][n]
        and all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _named_leaves(params), _named_leaves(ref_params))))
    del params, step, ref_params
    torch.cuda.empty_cache()
    # Readings: step intervals with another trial's step overlapping them
    # ("two at once") or not ("one"), beside the direct loop.
    spans, step_ms = [], []
    for r in grid:
        for m in r.metrics_history:
            spans.append((r.trial_id, m["t0"], m["t1"]))
            step_ms.append((m["t1"] - m["t0"]) * 1e3)
    both = _overlapping(spans)
    acks = sorted(_TUNE_ACKS)
    out = {
        "lrs": list(TUNE_LRS), "steps_run": {str(lr): ran[lr]
                                             for lr in TUNE_LRS},
        "rungs": list(asha.rungs), "best_lr": best_lr,
        "final_loss": {str(lr): final[lr] for lr in TUNE_LRS},
        "losses": {str(lr): [m["loss"] for m in trials[lr].metrics_history]
                   for lr in TUNE_LRS},
        "resumed_loss": resumed, "fit_s": fit_s,
        "trial_wall_s": {str(lr): r.metrics_history[-1]["t1"]
                         - r.metrics_history[-1]["t_start"]
                         for lr, r in trials.items()},
        "step_ms_p50_two_at_once": _p50(
            [t for t, o in zip(step_ms, both) if o]),
        "step_ms_p50_one_in_tuner": _p50(
            [t for t, o in zip(step_ms, both) if not o]),
        "steps_two_at_once": sum(both), "steps_one": len(both) - sum(both),
        "direct_step_ms_p50": _p50([t * 1e3 for lr in TUNE_LRS
                                    for t in direct[lr][1][1:]]),
        "checkpoint_save_s": [m["save_s"] for r in grid
                              for m in r.metrics_history
                              if m["step"] in ckpt_at],
        "report_ack_ms_p50": acks[len(acks) // 2] * 1e3,
        "report_ack_ms_p99": acks[min(len(acks) - 1,
                                      int(0.99 * len(acks)))] * 1e3,
        "reports": len(acks),
        "launches_per_trial_step": {k: v / n_steps
                                    for k, v in counts.items() if v},
        "plain_routes": plain}
    return checks, out


def _wf_effect(ctl, tag):
    """A step's side effect: its tag and process appended to the log,
    flushed to disk."""
    with open(ctl["effects"], "a") as f:
        f.write(f"{tag} {os.getpid()}\n")
        f.flush()
        os.fsync(f.fileno())


def _wf_table(ctl):
    """Phase 14's token table, cut to the workflow's batches."""
    rows = (WF_SEGMENTS * WF_SEGMENT_STEPS + 1) * ctl["batch"]
    return np.random.default_rng(SEED + 14).integers(
        0, ctl["cfg"].vocab_size, (rows, ctl["seq"] + 1))


def _wf_tokens(ctl):
    """The workflow's first step: the token table."""
    _wf_effect(ctl, "tokens")
    return _wf_table(ctl)


def _wf_segment(ctl, tokens, state, k):
    """Segment ``k``: WF_SEGMENT_STEPS flagship steps from the state the
    previous segment committed (seed-0 parameters for the first). Its
    output holds the parameters and the AdamW state, on the card, every
    segment's losses so far, and the device each later segment found the
    parameters on. At
    ``ctl["hold_at"]`` it parks at its start while the hold file exists,
    after writing the kernels' build record to the held file."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.ops import _build

    if k == ctl["hold_at"] and os.path.exists(ctl["hold"]):
        with open(ctl["held"], "w") as f:
            json.dump({"pid": os.getpid(), "nvcc_s": {
                name: info[0] for name, info in _build.build_info.items()}},
                f)
        deadline = time.monotonic() + WF_HOLD_S
        while os.path.exists(ctl["hold"]):
            if time.monotonic() > deadline:
                raise TimeoutError("segment held past WF_HOLD_S")
            time.sleep(0.02)
    _wf_effect(ctl, f"segment{k}")
    cfg, dev = ctl["cfg"], torch.device(ctl["device"])
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params, lr=WF_LR)
    in_devices, losses = [], []
    if state is not None:
        in_devices = state["in_devices"] + [
            str(state["params"]["embed"].device)]
        losses = list(state["losses"])
        with torch.no_grad():
            src = dict(_named_leaves(state["params"]))
            for name, t in _named_leaves(params):
                t.copy_(src[name])
        step.optimizer.load_state_dict(state["opt"])
    B = ctl["batch"]
    for j in range(WF_SEGMENT_STEPS):
        i = k * WF_SEGMENT_STEPS + j
        batch = torch.tensor(tokens[i * B:(i + 1) * B], device=dev)
        losses.append(step(batch[:, :-1], batch[:, 1:]).item())
    return {"params": params, "opt": step.optimizer.state_dict(),
            "losses": losses, "in_devices": in_devices}


def _wf_eval(ctl, tokens, state):
    """The last step: the loss of the trained parameters on the batch
    after the segments' (no gradient)."""
    from ray_tpu_torch import models as tm

    _wf_effect(ctl, "eval")
    i, B = WF_SEGMENTS * WF_SEGMENT_STEPS, ctl["batch"]
    batch = torch.tensor(tokens[i * B:(i + 1) * B],
                         device=torch.device(ctl["device"]))
    with torch.no_grad():
        loss = tm.loss_fn(ctl["cfg"], state["params"], batch[:, :-1],
                          batch[:, 1:]).item()
    return {"loss": loss, "in_device": str(state["params"]["embed"].device)}


def _wf_dag(ctl):
    """The workflow: tokens, WF_SEGMENTS chained segments, the
    evaluation."""
    from ray_tpu_torch import workflow

    tokens = workflow.step(_wf_tokens).options(name="tokens").bind(ctl)
    state = None
    for k in range(WF_SEGMENTS):
        state = workflow.step(_wf_segment).options(name="segment").bind(
            ctl, tokens, state, k)
    return workflow.step(_wf_eval).options(name="eval").bind(
        ctl, tokens, state)


@contextlib.contextmanager
def _timed_commits(path):
    """Every WorkflowStorage.commit_step of this process timed: one JSON
    line (step, seconds, bytes of the output file) appended to ``path``
    per commit."""
    from ray_tpu_torch.workflow.storage import WorkflowStorage

    commit = WorkflowStorage.commit_step

    def timed(self, workflow_id, step_id, value, meta=None):
        t0 = time.perf_counter()
        won, marker = commit(self, workflow_id, step_id, value, meta)
        seconds = time.perf_counter() - t0
        out = os.path.join(self.root, workflow_id, "steps", step_id,
                           f"output.{marker['token']}.pkl")
        with open(path, "a") as f:
            f.write(json.dumps({"step": step_id, "s": seconds,
                                "bytes": os.path.getsize(out),
                                "pid": os.getpid()}) + "\n")
        return won, marker

    with _patched(WorkflowStorage, "commit_step", timed):
        yield


def _workflow_child(ctl_path):
    """Phase 17 (b)'s child driver (another process, which imports this
    file as the module ``chip_smoke``): started while part (a) runs, it
    opens its CUDA context and the runtime, writes the ready file, waits
    (bounded) for the go file, then runs the workflow until the held
    segment, where the parent kills it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(ctl_path, "rb") as f:
        ctl = pickle.load(f)
    torch.zeros(1, device=ctl["device"])   # the CUDA context
    rt.init(num_cpus=2)
    try:
        with open(ctl["ready"], "w") as f:
            json.dump({"t": time.time()}, f)
        deadline = time.monotonic() + WF_CHILD_S
        while not os.path.exists(ctl["go"]):
            if time.monotonic() > deadline:
                raise TimeoutError("no go file within WF_CHILD_S")
            time.sleep(0.02)
        with _timed_commits(ctl["commits"]):
            workflow.run(_wf_dag(ctl), workflow_id=WF_ID,
                         storage=ctl["root"])
    finally:
        rt.shutdown()
    return 0


def _read_lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().split("\n")


def _workflow_start(cfg, dev, tmp):
    """Phase 17 (b)'s child driver, started: (ctl, the process, the
    wall time it was started at)."""
    os.makedirs(tmp)
    ctl = {"root": os.path.join(tmp, "wf_storage"),
           "effects": os.path.join(tmp, "effects.log"),
           "hold": os.path.join(tmp, "hold"),
           "held": os.path.join(tmp, "held.json"),
           "ready": os.path.join(tmp, "ready.json"),
           "go": os.path.join(tmp, "go"),
           "commits": os.path.join(tmp, "commits.jsonl"),
           "log": os.path.join(tmp, "child.log"),
           "device": str(dev), "hold_at": WF_HOLD_AT, "cfg": cfg,
           "batch": TRAIN_BATCH, "seq": TRAIN_LEN}
    with open(ctl["hold"], "w"):
        pass
    ctl_path = os.path.join(tmp, "ctl.pkl")
    with open(ctl_path, "wb") as f:
        pickle.dump(ctl, f)
    here = os.path.dirname(os.path.abspath(__file__))
    started = time.time()
    with open(ctl["log"], "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke; sys.exit(chip_smoke._workflow_child("
             "sys.argv[2]))", here, ctl_path],
            cwd=here, stdout=log, stderr=subprocess.STDOUT)
    return ctl, child, started


def _wait_for_file(path, child, ctl, what):
    """Poll for ``path`` (bounded by WF_CHILD_S) while the child lives."""
    deadline = time.monotonic() + WF_CHILD_S
    while not os.path.exists(path):
        if child.poll() is not None or time.monotonic() > deadline:
            with open(ctl["log"]) as f:
                tail = "".join(f.readlines()[-20:])
            raise AssertionError(f"phase 17 (b): the child driver did not "
                                 f"reach {what} (exit {child.poll()}): "
                                 f"{tail}")
        time.sleep(0.02)


def _workflow_part(cfg, dev, ctl, child, started):
    """Phase 17 (b): the workflow, its child driver killed with SIGKILL at
    a held segment and resumed here."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import chaos
    from ray_tpu_torch.util import state as rt_state
    from ray_tpu_torch.workflow.executor import step_ids_for

    fa, L = _flash_module(), cfg.n_layers
    checks = {}
    root = ctl["root"]
    _wait_for_file(ctl["ready"], child, ctl, "its ready file")
    with open(ctl["ready"]) as f:
        ready_s = json.load(f)["t"] - started
    t0 = time.perf_counter()
    with open(ctl["go"], "w"):
        pass
    try:
        # While the child runs its first segments: the uninterrupted run,
        # make_train_step called directly on the same batches, then the
        # evaluation loss.
        tokens = _wf_table(ctl)
        direct_losses, _, direct_params = _tune_direct(
            cfg, dev, tokens, WF_LR, WF_SEGMENTS * WF_SEGMENT_STEPS)
        i = WF_SEGMENTS * WF_SEGMENT_STEPS
        batch = torch.tensor(tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                             device=dev)
        with torch.no_grad():
            direct_eval = tm.loss_fn(cfg, direct_params, batch[:, :-1],
                                     batch[:, 1:]).item()
        _wait_for_file(ctl["held"], child, ctl, "the hold")
        to_hold_s = time.perf_counter() - t0
        # The chaos plane deals the SIGKILL: a seeded NodeKiller, started
        # when the child parks, kills it once after WF_KILL_AFTER_S (the
        # held marker is written, then the child's poll starts).
        killer = chaos.NodeKiller(
            [chaos.popen_kill_target("workflow_child", child,
                                     kind="driver")],
            seed=SEED + 17, interval_s=(WF_KILL_AFTER_S, WF_KILL_AFTER_S),
            max_kills=1)
        with killer:
            child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    os.unlink(ctl["hold"])
    with open(ctl["held"]) as f:
        held = json.load(f)
    checks["b_child_built_nothing"] = not any(held["nvcc_s"].values())
    checks["b_child_killed"] = child.returncode == -signal.SIGKILL
    snap = chaos.snapshot()
    chaos_kills = [(k["name"], k["kind"], k.get("pid"))
                   for k in rt_state.chaos_summary()["kills"]]
    checks["b_one_kill_recorded"] = (
        snap["num_kills"] == 1 and [(k["name"], k.get("pid"))
                                    for k in killer.kills]
        == [("workflow_child", child.pid)])
    checks["b_chaos_summary_shows_kill"] = chaos_kills == [
        ("workflow_child", "driver", child.pid)]
    dag = _wf_dag(ctl)
    ids = [sid for sid, _ in step_ids_for(dag)]
    store = workflow.WorkflowStorage(root)
    committed_before = [sid for sid in ids
                        if store.step_commit_record(WF_ID, sid)]
    checks["b_interrupted_running"] = (
        workflow.get_status(WF_ID, storage=root) == workflow.RUNNING)
    checks["b_committed_before_kill"] = committed_before == ids[:WF_HOLD_AT
                                                                 + 1]
    # The resume, here: traced, its commits timed, its launches counted.
    built = {k: v[0] for k, v in _build.build_info.items()}
    tracing.install()
    _zero_counts()
    plain = fa.plain_routes
    try:
        with _timed_commits(ctl["commits"]):
            t0 = time.perf_counter()
            result = workflow.resume(WF_ID, storage=root)
            resume_s = time.perf_counter() - t0
        spans = [sp for sp in tracing.local_spans()
                 if sp["name"] == "workflow.step"]
    finally:
        tracing.uninstall()
    counts, plain = _counts(), fa.plain_routes - plain
    ran_here = ids[WF_HOLD_AT + 1:]
    n_steps = (WF_SEGMENTS - WF_HOLD_AT) * WF_SEGMENT_STEPS
    checks["b_no_second_build"] = built == {
        k: v[0] for k, v in _build.build_info.items()}
    checks["b_launches_per_step"] = counts == _want_counts(
        "wgmma", (n_steps + 1) * L, n_steps * L)
    checks["b_plain_routes_0"] = plain == 0
    checks["b_span_per_step_here"] = sorted(
        (sp["tags"]["step"], sp["tags"]["attempt"]) for sp in spans) == [
        (sid, "1") for sid in sorted(ran_here)]
    effects = [line.split() for line in _read_lines(ctl["effects"]) if line]
    want = ["tokens"] + [f"segment{k}" for k in range(WF_SEGMENTS)] + [
        "eval"]
    checks["b_each_step_exactly_once"] = sorted(t for t, _ in effects) == \
        sorted(want)
    in_child = want[:WF_HOLD_AT + 1]
    checks["b_steps_split_across_processes"] = (
        {p for t, p in effects if t in in_child} == {str(held["pid"])}
        and {p for t, p in effects if t not in in_child}
        == {str(os.getpid())})
    # The first segment's output (the child committed it) and the last's.
    first, last = (store.load_step_output(WF_ID, sid)
                   for sid in (ids[1], ids[-2]))
    checks["b_losses_bit_equal_uninterrupted"] = \
        last["losses"] == direct_losses
    checks["b_final_params_bit_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            _named_leaves(last["params"]), _named_leaves(direct_params)))
    checks["b_eval_loss_bit_equal"] = result["loss"] == direct_eval
    checks["b_committed_tensor_on_its_device"] = (
        str(first["params"]["embed"].device) == str(dev)
        and last["in_devices"] == [str(dev)] * (WF_SEGMENTS - 1)
        and result["in_device"] == str(dev))
    workflow.init(root)
    listed = rt_state.list_workflows()
    checks["b_listed_success"] = [(w.workflow_id, w.status)
                                  for w in listed] == [(WF_ID, "SUCCESS")]
    commits = [json.loads(line) for line in _read_lines(ctl["commits"])
               if line]
    seg_ids = set(ids[1:-1])
    seg_losses = last["losses"]
    del first, last, direct_params
    torch.cuda.empty_cache()
    out = {
        "steps": ids, "committed_before_kill": committed_before,
        "ran_after_resume": ran_here, "child_start_to_ready_s": ready_s,
        "child_go_to_hold_s": to_hold_s,
        "child_nvcc_s": held["nvcc_s"], "resume_s": resume_s,
        "chaos_kills": chaos_kills,
        "segment_commit_s": [c["s"] for c in commits
                             if c["step"] in seg_ids],
        "segment_commit_bytes": [c["bytes"] for c in commits
                                 if c["step"] in seg_ids],
        "commits_by_process": {"child": sum(c["pid"] == held["pid"]
                                            for c in commits),
                               "parent": sum(c["pid"] == os.getpid()
                                             for c in commits)},
        "eval_loss": result["loss"], "direct_eval_loss": direct_eval,
        "losses": seg_losses,
        "launches_per_segment_step": {k: v / n_steps
                                      for k, v in counts.items() if v},
        "plain_routes": plain, "spans": len(spans),
        "workflows_listed": [(w.workflow_id, w.status) for w in listed],
        "summary": rt_state.summarize_workflows(listed)}
    return checks, out


def phase_tune(dev, card, cfg):
    """Phase 17 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.workflow import api as workflow_api

    t_phase = time.perf_counter()
    tokens = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, ((TRAINER_STEPS + TRAINER_MORE) * TRAIN_BATCH,
                            TRAIN_LEN + 1))
    checks, out, part_s = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    kept_storage = workflow_api._global_storage
    rt.shutdown()
    rt.init(num_cpus=4)
    child = None
    try:
        # (b)'s child driver starts first: its imports, CUDA context and
        # runtime come up while (a) runs; it waits for (b)'s go file.
        ctl, child, started = _workflow_start(cfg, dev,
                                              os.path.join(tmp, "b"))
        t0 = time.perf_counter()
        c, out["a"] = _tune_part(cfg, dev, tokens, os.path.join(tmp, "a"))
        part_s["a"] = time.perf_counter() - t0
        checks.update(c)
        t0 = time.perf_counter()
        c, out["b"] = _workflow_part(cfg, dev, ctl, child, started)
        part_s["b"] = time.perf_counter() - t0
        checks.update(c)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        workflow_api._global_storage = kept_storage
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    result = {"phase": "tune", "config": {
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "dtype": _dtype_name(cfg.dtype), "batch": [TRAIN_BATCH, TRAIN_LEN],
        "tune": {"lrs": list(TUNE_LRS), "max_t": TUNE_MAX_T,
                 "grace_period": TUNE_GRACE, "reduction_factor": TUNE_RF,
                 "max_concurrent_trials": TUNE_CONCURRENT},
        "workflow": {"segments": WF_SEGMENTS,
                     "steps_per_segment": WF_SEGMENT_STEPS,
                     "killed_at_segment": WF_HOLD_AT}},
        "checks": checks, **out, "part_s": part_s,
        "phase_s": time.perf_counter() - t_phase,
        "temporary_dirs_left": os.path.exists(tmp), "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed or result["temporary_dirs_left"]:
        raise AssertionError(f"phase 17 (tune) failed {failed}")
    return result


# ------------------------------------------------------- phase 18: util
def _util_placement(cfg, dev):
    """Phase 18 (a): the flagship's bf16 train step in an actor placed by
    a placement group's strategy. Returns (checks, readings)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import util
    from ray_tpu_torch.util import state as rt_state

    fa, L = _flash_module(), cfg.n_layers
    checks = {}
    tokens = np.random.default_rng(SEED + 18).integers(
        0, cfg.vocab_size, (UTIL_TRAIN_STEPS * TRAIN_BATCH, TRAIN_LEN + 1))
    direct, direct_s, _, _ = _trainer_direct(cfg, dev, tokens,
                                             UTIL_TRAIN_STEPS)
    total = rt.cluster_resources()["CPU"]
    pg = util.placement_group([{"CPU": 1}], strategy="PACK")
    checks["a_group_ready"] = pg.wait(SERVE_POLL_S)
    checks["a_reservation_shown"] = \
        rt.available_resources()["CPU"] == total - 1
    listed = rt_state.list_placement_groups()
    checks["a_listed_created"] = [(g["strategy"], g["state"])
                                  for g in listed] == [("PACK", "CREATED")]

    @rt.remote
    class PlacedTrainer:
        def __init__(self):
            from ray_tpu_torch import models as tm

            self.step_fn = tm.make_train_step(
                cfg, tm.init_params(cfg, SEED, device=dev))

        def step(self, batch_tokens):
            batch = torch.tensor(batch_tokens, device=dev)
            return self.step_fn(batch[:, :-1], batch[:, 1:]).item()

    trainer = PlacedTrainer.options(
        scheduling_strategy=util.PlacementGroupSchedulingStrategy(
            pg, 0)).remote()
    losses, counts, plain, step_s = [], [], [], []
    for i in range(UTIL_TRAIN_STEPS):
        _zero_counts()
        plain0 = fa.plain_routes
        t0 = time.perf_counter()
        losses.append(rt.get(trainer.step.remote(
            tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]),
            timeout=SERVE_POLL_S * 4))
        step_s.append(time.perf_counter() - t0)
        counts.append(_counts())
        plain.append(fa.plain_routes - plain0)
    rt.kill(trainer)
    _check_actor_steps("phase 18 (a)", direct, losses, counts, plain, L)
    checks["a_losses_bit_equal_direct"] = True
    checks["a_launches_per_step"] = True
    try:
        util.placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
        checks["a_strict_spread_raises"] = False
    except ValueError:
        checks["a_strict_spread_raises"] = True
    util.remove_placement_group(pg)
    checks["a_resources_returned"] = \
        rt.available_resources()["CPU"] == total
    checks["a_table_empty"] = rt_state.list_placement_groups() == []
    del trainer
    torch.cuda.empty_cache()
    return checks, {
        "losses": losses, "direct_losses": direct,
        "step_ms_p50": _p50(step_s) * 1e3,
        "direct_step_ms_p50": _p50(direct_s) * 1e3,
        "launches_per_step": counts[-1], "plain_routes": sum(plain)}


def _util_batch(cfg, dev):
    """Phase 18 (b): @serve.batch over the flagship's forward, each batch
    padded to a fixed [UTIL_BATCH_ROWS, UTIL_BATCH_LEN]. Returns (checks,
    readings)."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch import serve

    fa = _flash_module()
    params = tm.init_params(cfg, SEED, device=dev)
    rng = np.random.default_rng(SEED + 19)
    lens = rng.integers(8, UTIL_BATCH_LEN + 1, UTIL_BATCH_PROMPTS).tolist()
    prompts = _prompts(rng, lens, cfg.vocab_size)

    def fixed_forward(rows):
        """forward over one fixed [UTIL_BATCH_ROWS, UTIL_BATCH_LEN]
        batch; rows[i] is the prompt in row i (None: zeros). Each
        prompt's last-position logits on the host."""
        tokens = torch.zeros(UTIL_BATCH_ROWS, UTIL_BATCH_LEN,
                             dtype=torch.long, device=dev)
        for i, p in enumerate(rows):
            if p is not None:
                tokens[i, :len(p)] = torch.tensor(p, device=dev)
        with torch.no_grad():
            logits = tm.forward(cfg, params, tokens)
        return [None if p is None else logits[i, len(p) - 1].cpu()
                for i, p in enumerate(rows)]

    @serve.deployment
    class BatchedLM:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=UTIL_BATCH_ROWS,
                     batch_wait_timeout_s=UTIL_BATCH_WAIT_S)
        def __call__(self, batch):
            self.sizes.append(len(batch))
            rows = fixed_forward(batch)
            return [{"row": i, "size": len(batch), "logits": r,
                     "token": int(r.argmax())} for i, r in enumerate(rows)]

        def batch_sizes(self):
            return list(self.sizes)

    handle = serve.run(BatchedLM.bind(), name="batched_lm")
    handle.remote(prompts[0]).result(timeout=SERVE_POLL_S * 4)  # warm-up
    with _counts_kept(fa):
        _zero_counts()
        plain0 = fa.plain_routes
        t0 = time.perf_counter()
        responses = [handle.remote(p) for p in prompts]
        served = [r.result(timeout=SERVE_POLL_S * 4) for r in responses]
        wall = time.perf_counter() - t0
        counts, plain = _counts(), fa.plain_routes - plain0
    sizes = handle.batch_sizes.remote().result(timeout=SERVE_POLL_S)[1:]
    serve.delete("batched_lm")
    with _counts_kept(fa):
        direct = [fixed_forward([None] * s["row"] + [p]
                                + [None] * (UTIL_BATCH_ROWS - 1 - s["row"])
                                )[s["row"]]
                  for s, p in zip(served, prompts)]
    errs = [(s["logits"] - d).abs().max().item()
            for s, d in zip(served, direct)]
    checks = {
        "b_coalesced": max(sizes) > 1,
        "b_every_request_served": sum(sizes) == len(prompts),
        "b_tokens_equal_direct": [s["token"] for s in served]
        == [int(d.argmax()) for d in direct],
        "b_logits_within_tol": max(errs) <= UTIL_BATCH_LOGIT_TOL,
        "b_launches_per_batch": counts == _want_counts(
            "wgmma", cfg.n_layers * len(sizes), 0) and plain == 0}
    del params
    torch.cuda.empty_cache()
    return checks, {
        "batch_sizes": sizes, "batches": len(sizes),
        "logit_max_abs_err": max(errs), "wall_s": wall,
        "launches": counts, "plain_routes": plain,
        "launches_per_batch": counts["fwd"] / len(sizes)}


def _loadgen_shape():
    from ray_tpu_torch.util import loadgen

    (r0, r1, d0), (peak, d1), (r2, r3, d2) = UTIL_LOADGEN_SHAPE
    return (loadgen.Ramp(r0, r1, d0) >> loadgen.Spike(peak, d1)
            >> loadgen.Ramp(r2, r3, d2))


def _util_loadgen(cfg, dev):
    """Phase 18 (c): the served flagship (phase 13's LLMServer through
    the handle) unarmed, then armed with the sanitizer and driven by a
    seeded loadgen episode. Returns (checks, readings)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, build_llm_app
    from ray_tpu_torch.util import loadgen, sanitizer

    fa = _flash_module()
    prompts = _prompts(np.random.default_rng(SEED + 20), UTIL_LOADGEN_LENS,
                       cfg.vocab_size)
    n_new = UTIL_LOADGEN_TOKENS
    want = [d[0] for d in _engine_streams(cfg, dev, prompts, n_new)]
    app = build_llm_app(EngineConfig(
        model=cfg, num_blocks=SERVE_NUM_BLOCKS, block_size=BLOCK_SIZE,
        device=str(dev)), name="llm_util")
    ttft = {}
    checks = {}
    for armed in (False, True):
        rt.shutdown()
        sanitizer.enable(armed)
        sanitizer.clear()
        rt.init(num_cpus=4)
        try:
            checks[f"c_watchdog_{'armed' if armed else 'off'}"] = (
                (rt._private.worker.global_worker().sanitizer_watchdog
                 is not None) == armed)
            handle = serve.run(app)
            # The first request pays the replica's first-use costs.
            list(handle.options(stream=True).remote(
                {"prompt": prompts[0], "max_new_tokens": 2}))
            runs = _served_streams(
                handle, [prompts[i % len(prompts)]
                         for i in range(UTIL_TTFT_REQUESTS)], n_new)
            ttft["armed" if armed else "unarmed"] = _p50(
                [r[1] for r in runs])
            if not armed:
                continue
            outs = {}

            def fire(i, t):
                p = i % len(prompts)
                toks = list(handle.options(stream=True).remote(
                    {"prompt": prompts[p], "max_new_tokens": n_new}))
                outs[i] = (p, toks)
                return len(toks)

            shape = _loadgen_shape()
            with _counts_kept(fa):
                _zero_counts()
                plain0 = fa.plain_routes
                gen = loadgen.LoadGenerator(shape, fire,
                                            seed=UTIL_LOADGEN_SEED)
                records = gen.run(timeout_s=SERVE_POLL_S * 4)
                counts = {n: getattr(fa, n) for n in _COUNTERS}
                counts["plain_routes"] = fa.plain_routes - plain0
            summary = gen.summary()
            ok = [r for r in records if r.outcome == "ok"]
            checks["c_every_request_ok"] = len(ok) == len(records) > 0
            checks["c_ok_tokens_equal_engine"] = all(
                outs[r.index][1] == want[outs[r.index][0]] for r in ok)
            checks["c_schedule_replays"] = (
                shape.schedule(UTIL_LOADGEN_SEED) == gen.schedule
                == loadgen.LoadGenerator(_loadgen_shape(), fire,
                                         seed=UTIL_LOADGEN_SEED).schedule)
            checks["c_no_flash_launch"] = not any(counts.values())
            checks["c_no_violation"] = sanitizer.violations() == []
            violations = sanitizer.violations()
        finally:
            serve.shutdown()
            rt.shutdown()
            sanitizer.enable(False)
    # The runtime's shutdown joined the watchdog; the generator's pool
    # threads end once their last fire has returned (bounded wait).
    for t in threading.enumerate():
        if t.name.startswith(("ray_tpu_sanitizer_watch", "ray_tpu_loadgen")):
            t.join(SERVE_POLL_S)
    checks["c_threads_joined"] = not [
        t for t in threading.enumerate()
        if t.name.startswith(("ray_tpu_sanitizer_watch", "ray_tpu_loadgen"))]
    return checks, {
        "shape": _loadgen_shape().describe(), "seed": UTIL_LOADGEN_SEED,
        "summary": summary, "violations": violations,
        "ttft_p50_s": ttft,
        "flash_counters_on_served_path": counts}


def phase_util(dev, card, cfg):
    """Phase 18 (module docstring)."""
    import ray_tpu_torch as rt

    t_phase = time.perf_counter()
    checks, out, part_s = {}, {}, {}
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        for part, fn in (("a", _util_placement), ("b", _util_batch)):
            t0 = time.perf_counter()
            c, out[part] = fn(cfg, dev)
            part_s[part] = time.perf_counter() - t0
            checks.update(c)
    finally:
        from ray_tpu_torch import serve

        serve.shutdown()
        rt.shutdown()
    t0 = time.perf_counter()
    c, out["c"] = _util_loadgen(cfg, dev)
    part_s["c"] = time.perf_counter() - t0
    checks.update(c)
    result = {"phase": "util", "config": {
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "dtype": _dtype_name(cfg.dtype),
        "train_batch": [TRAIN_BATCH, TRAIN_LEN],
        "serve_batch": [UTIL_BATCH_ROWS, UTIL_BATCH_LEN],
        "loadgen_prompt_lens": list(UTIL_LOADGEN_LENS),
        "loadgen_new_tokens": UTIL_LOADGEN_TOKENS},
        "checks": checks, **out, "part_s": part_s,
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 18 (util) failed {failed}")
    return result


# -------------------------------------------------------- phase 19: process
def _proc_token_rows(batch, vocab, length, kill_row, kill_dir=None):
    """Phase 19 (b)'s map_batches stage, in a worker process: each row id
    becomes ``length`` seeded tokens, with the worker's pid beside them.
    With ``kill_dir`` the first attempt of the batch that starts at row
    ``kill_row`` writes its pid there and waits to be SIGKILLed."""
    ids = np.asarray(batch["id"])
    if kill_dir is not None and int(ids[0]) == kill_row:
        flag = os.path.join(kill_dir, "victim")
        if not os.path.exists(flag):
            with open(flag + ".tmp", "w") as fh:
                fh.write(str(os.getpid()))
            os.replace(flag + ".tmp", flag)
            time.sleep(PROC_POLL_S)
    tokens = np.stack([np.random.default_rng(SEED + 19_000 + int(i)).integers(
        0, vocab, length) for i in ids]).astype(np.int64)
    return {"tokens": tokens,
            "pid": np.full(len(ids), os.getpid(), dtype=np.int64)}


def _proc_probe():
    """What a task sees of the card: its pid, CUDA_VISIBLE_DEVICES and
    torch.cuda.is_available()."""
    import torch as _torch

    return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
            _torch.cuda.is_available())


def _proc_describe(t):
    return t.device.type, str(t.dtype), tuple(t.shape), t


def _proc_big(n):
    import torch as _torch

    return _torch.arange(n, dtype=_torch.float32)


def _proc_nop():
    return None


def _proc_say(tag):
    print(tag, flush=True)
    return os.getpid()


class _ProcVictim:
    def pid(self):
        return os.getpid()

    def ping(self):
        return 1


class _ProcCardActor:
    """Phase 19 (d)'s actor with runtime="driver": it builds the flagship
    on the card and takes one train step."""

    def __init__(self, cfg, dev):
        from ray_tpu_torch import models as tm

        self.params = tm.init_params(cfg, SEED, device=dev)
        self.step = tm.make_train_step(cfg, self.params)

    def train(self, tokens):
        t = torch.as_tensor(tokens, device=self.params["embed"].device)
        loss = self.step(t[:, :-1], t[:, 1:]).item()
        return str(self.params["embed"].device), loss


def _proc_pipeline(data, cfg, dev, kill_dir=None):
    """Phase 19 (b): PROC_TRAIN_STEPS flagship bf16 steps in the driver,
    each on a batch that the Dataset's map_batches stage built (in worker
    processes on the process plane), through iter_torch_batches onto the
    card. Returns the losses, step seconds, the stage's pids, the K1/K3/K4
    launches and plain routes of the run, and (with ``kill_dir``) the pid
    SIGKILLed mid-map."""
    from ray_tpu_torch import models as tm

    fa = _flash_module()
    killed = []
    watcher = None
    if kill_dir is not None:
        def _watch():
            flag = os.path.join(kill_dir, "victim")
            deadline = time.monotonic() + PROC_POLL_S
            while not os.path.exists(flag) and time.monotonic() < deadline:
                time.sleep(0.01)
            if os.path.exists(flag):
                with open(flag) as fh:
                    pid = int(fh.read())
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)

        watcher = threading.Thread(target=_watch, daemon=True)
        watcher.start()
    ds = data.range(PROC_TRAIN_STEPS * TRAIN_BATCH,
                    parallelism=PROC_TRAIN_STEPS).map_batches(
        _proc_token_rows, batch_size=TRAIN_BATCH,
        fn_kwargs={"vocab": cfg.vocab_size, "length": TRAIN_LEN + 1,
                   "kill_row": PROC_KILL_BATCH * TRAIN_BATCH,
                   "kill_dir": kill_dir})
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, step_s, pids = [], [], set()
    _zero_counts()
    plain = fa.plain_routes
    for batch in ds.iter_torch_batches(batch_size=TRAIN_BATCH, device=dev):
        tokens = batch["tokens"]
        pids.update(int(p) for p in batch["pid"].tolist())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(tokens[:, :-1], tokens[:, 1:]).item())
        step_s.append(time.perf_counter() - t0)
    counts, plain_t = _counts(), fa.plain_routes - plain
    if watcher is not None:
        watcher.join(PROC_POLL_S)
    del params, step
    torch.cuda.empty_cache()
    return losses, step_s, pids, counts, plain_t, killed


def _proc_round_trips(rt):
    """Seconds of PROC_ROUND_TRIPS trivial tasks, one get at a time,
    after one warm-up."""
    fn = rt.remote(_proc_nop)
    rt.get(fn.remote(), timeout=PROC_POLL_S)
    out = []
    for _ in range(PROC_ROUND_TRIPS):
        t0 = time.perf_counter()
        rt.get(fn.remote(), timeout=PROC_POLL_S)
        out.append(time.perf_counter() - t0)
    return out


def _proc_boots(w):
    """Worker boot, from spawn to its first reply (a ping), PROC_BOOTS
    times."""
    from ray_tpu_torch._private.config import GlobalConfig
    from ray_tpu_torch._private.worker_pool import WorkerProcess

    out = []
    for _ in range(PROC_BOOTS):
        t0 = time.perf_counter()
        wp = WorkerProcess(w.shm_store,
                           max_msg=GlobalConfig.worker_channel_bytes)
        try:
            wp.request(("ping",), timeout=PROC_POLL_S)
            out.append(time.perf_counter() - t0)
        finally:
            wp.shutdown()
    return out


def _proc_shm_rates(store):
    """GB/s of a 64 MiB put into the shm store and of its get back out,
    PROC_SHM_ITERS times each; the bytes come back equal."""
    data = np.random.default_rng(SEED + 19).bytes(PROC_SHM_BYTES)
    puts, gets, equal = [], [], True
    for i in range(PROC_SHM_ITERS):
        key = 0x0B19_0000 + i
        t0 = time.perf_counter()
        store.put(key, data)
        t1 = time.perf_counter()
        back = store.get(key)
        t2 = time.perf_counter()
        equal = equal and back == data
        store.delete(key)
        puts.append(PROC_SHM_BYTES / (t1 - t0) / 1e9)
        gets.append(PROC_SHM_BYTES / (t2 - t1) / 1e9)
    return _p50(puts), _p50(gets), equal


def _proc_crossing(rt, dev):
    """Phase 19 (c): a CUDA tensor as an argument and a driver put of one
    passed by ref arrive in the worker as CPU tensors with equal values;
    the driver's own get keeps the card; a 64 MiB return rides the shm
    store back."""
    checks = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x = torch.randn(1024, 1024, device=dev, generator=gen)
    describe, big = rt.remote(_proc_describe), rt.remote(_proc_big)
    kind, dtype, shape, back = rt.get(describe.remote(x),
                                      timeout=PROC_POLL_S)
    checks["c_cuda_arg_arrives_on_cpu"] = (
        kind == "cpu" and dtype == "torch.float32" and shape == (1024, 1024)
        and back.device.type == "cpu" and torch.equal(back, x.cpu()))
    ref = rt.put(x)
    kind, _, _, back = rt.get(describe.remote(ref), timeout=PROC_POLL_S)
    checks["c_put_ref_arrives_on_cpu"] = (kind == "cpu"
                                          and torch.equal(back, x.cpu()))
    mine = rt.get(ref, timeout=PROC_POLL_S)
    checks["c_driver_get_keeps_the_card"] = (
        mine.device == x.device and torch.equal(mine, x))
    n = PROC_SHM_BYTES // 4
    t0 = time.perf_counter()
    got = rt.get(big.remote(n), timeout=PROC_POLL_S)
    big_s = time.perf_counter() - t0
    checks["c_64MiB_return_equal"] = (
        got.device.type == "cpu" and got.numel() == n
        and torch.equal(got, torch.arange(n, dtype=torch.float32)))
    return checks, {"return_64MiB_s": big_s}


def _proc_isolation(rt, cfg, dev, w):
    """Phase 19 (d)'s actors: a SIGKILLed process actor answers
    ActorDiedError while the driver's step and the card go on; an actor
    with runtime="driver" builds the flagship on the card."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.exceptions import ActorDiedError

    checks = {}
    victim = rt.remote(_ProcVictim).remote()
    vpid = rt.get(victim.pid.remote(), timeout=PROC_POLL_S)
    os.kill(vpid, signal.SIGKILL)
    try:
        rt.get(victim.ping.remote(), timeout=PROC_POLL_S)
        died = "no error"
    except ActorDiedError as exc:
        died = type(exc).__name__
    checks["d_killed_actor_died"] = (died == "ActorDiedError"
                                     and vpid != os.getpid())
    tokens = np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1))
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    t = torch.as_tensor(tokens, device=dev)
    loss = step(t[:, :-1], t[:, 1:]).item()
    checks["d_driver_step_after_kill"] = bool(np.isfinite(loss))
    del params, step
    card = rt.remote(runtime="driver")(_ProcCardActor).remote(cfg, dev)
    where, aloss = rt.get(card.train.remote(tokens), timeout=PROC_POLL_S)
    checks["d_driver_actor_on_card"] = (
        where == str(torch.device(dev.type, 0) if dev.type == "cuda"
                     else dev) and aloss == loss)
    rt.kill(card)
    torch.cuda.empty_cache()
    return checks, {"killed_actor_pid": vpid, "driver_actor_device": where}


class _Tee:
    """The log monitor's sink in phase 19 (e): the driver's stderr, and a
    copy the phase reads."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        sys.stderr.write(s)
        self.parts.append(s)

    def flush(self):
        sys.stderr.flush()

    def text(self):
        return "".join(self.parts)


def _proc_logs(rt, w):
    checks = {}
    tee = _Tee()
    w.log_monitor._sink = tee
    tag = f"chip_smoke-phase19-{os.getpid()}"
    wpid = rt.get(rt.remote(_proc_say).remote(tag), timeout=PROC_POLL_S)
    log_dir = os.path.join(w.session_dir, "logs")

    def _in_files():
        for name in os.listdir(log_dir):
            with open(os.path.join(log_dir, name), errors="replace") as fh:
                if tag in fh.read():
                    return name
        return None

    deadline = time.monotonic() + PROC_POLL_S
    while (tag not in tee.text() or _in_files() is None) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    checks["e_print_in_session_log"] = _in_files() is not None
    checks["e_print_on_driver_stderr"] = (
        f"pid={wpid}) {tag}" in tee.text())
    return checks, {"log_file": _in_files(), "session_dir": w.session_dir}


def phase_process(dev, card, cfg):
    """Phase 19 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch._private.config import GlobalConfig

    t_phase = time.perf_counter()
    L = cfg.n_layers
    checks, out, part_s = {}, {}, {}
    shm_free = shutil.disk_usage("/dev/shm").free
    need = GlobalConfig.shm_store_bytes
    out["dev_shm_free_bytes"] = shm_free
    print(f"chip_smoke: /dev/shm has {shm_free} bytes free; the process "
          f"plane's store maps {need}", flush=True)
    if shm_free < need:
        raise AssertionError(
            f"phase 19 (process): /dev/shm has {shm_free} bytes free, "
            f"under the {need} the shm store maps")
    # The thread plane: the oracle's losses and step times, and its
    # trivial round trip.
    rt.shutdown()
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        t_losses, t_step_s, t_pids, _, _, _ = _proc_pipeline(data, cfg, dev)
        t_trips = _proc_round_trips(rt)
    finally:
        rt.shutdown()
    part_s["thread"] = time.perf_counter() - t0
    checks["thread_stage_in_driver"] = t_pids == {os.getpid()}
    kill_dir = tempfile.mkdtemp(prefix="chip_smoke_proc_")
    rt.init(num_cpus=4, worker_mode="process")
    w = rt._private.worker.global_worker()
    children, segment = set(), w.shm_store.name
    try:
        # (a) Workers see no card; the driver's resources keep it.
        t0 = time.perf_counter()
        probe = rt.remote(_proc_probe)
        gpus = rt.cluster_resources().get("GPU", 0.0)
        a = [rt.get(probe.remote(), timeout=PROC_POLL_S)]
        if gpus:   # a task that asks for the card runs without it too
            a.append(rt.get(probe.options(num_gpus=1).remote(),
                            timeout=PROC_POLL_S))
        checks["a_tasks_see_no_card"] = all(
            pid != os.getpid() and cvd == "" and not avail
            for pid, cvd, avail in a)
        checks["a_driver_keeps_the_card"] = (
            gpus == float(torch.cuda.device_count()) and (
                dev.type != "cuda" or gpus >= 1.0))
        out["a"] = {"probes": a, "driver_gpus": gpus}
        boots = _proc_boots(w)
        p_trips = _proc_round_trips(rt)
        part_s["a"] = time.perf_counter() - t0
        # (b) The flagship's train step fed from worker processes.
        t0 = time.perf_counter()
        losses, step_s, pids, counts, plain_t, _ = _proc_pipeline(
            data, cfg, dev)
        children.update(w.worker_pool.pids())
        want = _want_counts("wgmma", PROC_TRAIN_STEPS * L,
                            PROC_TRAIN_STEPS * L)
        checks["b_stage_in_worker_processes"] = bool(pids) and (
            os.getpid() not in pids and pids <= set(w.worker_pool.pids()))
        checks["b_losses_bit_equal_thread_plane"] = (
            len(losses) == PROC_TRAIN_STEPS and losses == t_losses)
        checks["b_launches_per_step"] = counts == want
        checks["b_plain_routes_0"] = plain_t == 0
        out["b"] = {"losses": losses, "thread_losses": t_losses,
                    "stage_pids": sorted(pids),
                    "launches_per_step": {k: v / PROC_TRAIN_STEPS
                                          for k, v in counts.items() if v},
                    "plain_routes": plain_t}
        part_s["b"] = time.perf_counter() - t0
        # (c) Crossing the boundary.
        t0 = time.perf_counter()
        c, out["c"] = _proc_crossing(rt, dev)
        checks.update(c)
        shm_put, shm_get, shm_equal = _proc_shm_rates(w.shm_store)
        checks["c_shm_bytes_equal"] = shm_equal
        part_s["c"] = time.perf_counter() - t0
        # (d) Isolation beside the card.
        t0 = time.perf_counter()
        k_losses, _, k_pids, _, _, killed = _proc_pipeline(
            data, cfg, dev, kill_dir=kill_dir)
        children.update(w.worker_pool.pids())
        checks["d_map_worker_killed"] = len(killed) == 1 and (
            killed[0] not in k_pids)
        checks["d_losses_after_kill_bit_equal"] = k_losses == t_losses
        c, out["d"] = _proc_isolation(rt, cfg, dev, w)
        checks.update(c)
        out["d"]["killed_map_pid"] = killed
        part_s["d"] = time.perf_counter() - t0
        # (e) Logs.
        t0 = time.perf_counter()
        c, out["e"] = _proc_logs(rt, w)
        checks.update(c)
        part_s["e"] = time.perf_counter() - t0
        children.update(w.worker_pool.pids())
        children.update(a.pid for a in w.actors.values() if a.pid)
    finally:
        rt.shutdown()
        shutil.rmtree(kill_dir, ignore_errors=True)
    deadline = time.monotonic() + 10.0
    while any(_alive(p) for p in children) and time.monotonic() < deadline:
        time.sleep(0.02)
    checks["workers_gone_after_shutdown"] = not any(
        _alive(p) for p in children)
    checks["segment_unlinked"] = not os.path.exists("/dev/shm" + segment)
    result = {
        "phase": "process", "config": {
            "d_model": cfg.d_model, "n_layers": L,
            "dtype": _dtype_name(cfg.dtype),
            "train_batch": [TRAIN_BATCH, TRAIN_LEN],
            "steps": PROC_TRAIN_STEPS, "num_cpus": 4},
        "checks": checks, **out,
        "readings": {
            "worker_boot_s_p50": _p50(boots),
            "worker_boot_s": boots,
            "task_round_trip_ms_p50": _p50(p_trips) * 1e3,
            "thread_task_round_trip_ms_p50": _p50(t_trips) * 1e3,
            "shm_put_64MiB_GBps": shm_put, "shm_get_64MiB_GBps": shm_get,
            "timed_steps": len(step_s) - 1,
            "step_ms_p50": _p50(step_s[1:]) * 1e3,
            "thread_fed_step_ms_p50": _p50(t_step_s[1:]) * 1e3,
            "step_ms_p10_p50_p90": _deciles_ms(step_s[1:]),
            "thread_fed_step_ms_p10_p50_p90": _deciles_ms(t_step_s[1:]),
            "step_ms": [x * 1e3 for x in step_s],
            "thread_fed_step_ms": [x * 1e3 for x in t_step_s]},
        "part_s": part_s, "phase_s": time.perf_counter() - t_phase,
        "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 19 (process) failed {failed}")
    return result


def _cluster_batch(i, vocab, batch, length):
    """Phase 20's batch ``i``: [batch, length] seeded int64 tokens on the
    CPU (inputs are ``[:, :-1]``, labels ``[:, 1:]``)."""
    rng = np.random.default_rng(SEED + 20_000 + i)
    return torch.from_numpy(rng.integers(0, vocab, (batch, length)))


class _ClusterTrainer:
    """Phase 20's named actor: make_train_step on its device. ``step``
    takes a batch (pulled through the head when another driver sent it),
    publishes ``[i, loss]`` on ``topic`` and returns the loss."""

    def __init__(self, cfg, dev, topic, params=None):
        from ray_tpu_torch import models as tm

        self.params = (params if params is not None
                       else tm.init_params(cfg, SEED, device=dev))
        self.step_fn = tm.make_train_step(cfg, self.params)
        self.dev, self.topic = torch.device(dev), topic
        self.steps, self.step_s = 0, []

    def ping(self):
        return self.steps

    def step(self, tokens):
        from ray_tpu_torch.util import pubsub

        t = torch.as_tensor(tokens).to(self.dev)
        _sync(self.dev)
        t0 = time.perf_counter()
        loss = self.step_fn(t[:, :-1], t[:, 1:]).item()
        self.step_s.append(time.perf_counter() - t0)
        pubsub.publish(self.topic, [self.steps, loss])
        self.steps += 1
        return loss

    def step_seconds(self):
        return list(self.step_s)


def _cluster_peer(spec_json: str) -> int:
    """Phase 20's peer driver (a subprocess: ``python -c "import
    chip_smoke, sys; sys.exit(chip_smoke._cluster_peer(sys.argv[1]))"
    SPEC``). It attaches to the head at spec["address"], subscribes to
    the topic, times spec["relay_calls"] relayed pings, puts, announces
    and steps spec["steps"] batches through get_actor(spec["actor"]),
    reads the topic, then announces a spec["pull_bytes"] object (none for
    0); batches start at spec.get("first", 0), and with spec["go"] it
    puts spec["key"] + "/attached" and waits for that go key before it
    resolves the actor. Its results go to
    the KV under spec["key"] as JSON. It holds its objects
    until spec["key"] + "/done" appears or it is killed."""
    import traceback

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import pubsub

    spec = json.loads(spec_json)
    w = rt.init(num_cpus=1, address=spec["address"])
    out = {"pid": os.getpid(), "client": w.head_client.client_id}
    poll = spec["poll_s"]
    try:
        if spec.get("go"):
            w.kv_put((spec["key"] + "/attached").encode(), b"1")
            deadline = time.monotonic() + 4 * poll
            while w.kv_get(spec["go"].encode()) is None:
                if time.monotonic() > deadline:
                    raise TimeoutError("no go key")
                time.sleep(0.05)
        # (A subscription made before a head restart is re-asserted by
        # the next heartbeat: a message published before that is lost,
        # at most once as in the reference. Subscribe after the go.)
        sub = pubsub.subscribe(spec["topic"])
        deadline = time.monotonic() + poll
        while True:
            try:
                trainer = rt.get_actor(spec["actor"])
                break
            except ValueError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        out["handle"] = type(trainer).__name__
        rt.get(trainer.ping.remote(), timeout=poll)
        trips = []
        for _ in range(spec["relay_calls"]):
            t0 = time.perf_counter()
            rt.get(trainer.ping.remote(), timeout=poll)
            trips.append(time.perf_counter() - t0)
        losses, step_s = [], []
        for i in range(spec.get("first", 0),
                       spec.get("first", 0) + spec["steps"]):
            ref = rt.put(_cluster_batch(i, spec["vocab"], spec["batch"],
                                        spec["length"]))
            rt.announce_object(ref)
            t0 = time.perf_counter()
            losses.append(rt.get(trainer.step.remote(ref), timeout=poll))
            step_s.append(time.perf_counter() - t0)
        msgs = [sub.get(timeout=poll) for _ in range(spec["steps"])]
        if spec["pull_bytes"]:
            big = np.random.default_rng(SEED + 20_001).integers(
                0, 256, spec["pull_bytes"], dtype=np.uint8)
            bref = rt.put(big)
            rt.announce_object(bref)
            out.update(big_oid=bref.hex(),
                       big_sum=int(big.sum(dtype=np.int64)))
        out.update(losses=losses, step_s=step_s, trips_s=trips,
                   msgs=[list(m) for m in msgs],
                   cuda_initialized=torch.cuda.is_initialized(),
                   cuda_available=torch.cuda.is_available(),
                   visible=os.environ.get("CUDA_VISIBLE_DEVICES"))
    except BaseException:  # noqa: BLE001 — reported to the smoke driver
        out["error"] = traceback.format_exc()
    w.kv_put(spec["key"].encode(), json.dumps(out).encode())
    done = (spec["key"] + "/done").encode()
    deadline = time.monotonic() + spec["hold_s"]
    while time.monotonic() < deadline and w.kv_get(done) is None:
        time.sleep(0.05)
    rt.shutdown()
    return 0 if "error" not in out else 1


def _cluster_env(**extra):
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _start_head(state, port=0, env=None):
    """A port head process on ``port`` over ``state``: (process, address,
    seconds to its address line)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.head_service",
         "--port", str(port), "--state", state],
        stdout=subprocess.PIPE, text=True, env=env or _cluster_env())
    try:
        line = _read_line(proc, CLUSTER_POLL_S)
    except TimeoutError:
        line = None
    if line is None or not line.startswith(
            "ray_tpu_torch head listening on "):
        proc.kill()
        proc.wait(timeout=10)
        raise RuntimeError(f"the head did not start within "
                           f"{CLUSTER_POLL_S} s: {line!r}")
    return proc, line.strip().rsplit(" ", 1)[-1], time.perf_counter() - t0


def _read_line(proc, bound):
    """The next line of ``proc``'s piped stdout, or TimeoutError past
    ``bound`` seconds (the process is left running)."""
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=bound):
            raise TimeoutError(f"no line from pid {proc.pid} within "
                               f"{bound} s")
    return proc.stdout.readline()


def _start_peer(spec):
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke._cluster_peer(sys.argv[1]))",
         json.dumps(spec)],
        env=_cluster_env(CUDA_VISIBLE_DEVICES=""))


def _wait_json(w, key, peer, bound):
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline:
        raw = w.kv_get(key.encode())
        if raw is not None:
            return json.loads(raw)
        if peer.poll() is not None:
            raise RuntimeError(f"the peer driver exited ({peer.returncode}) "
                               f"before reporting")
        time.sleep(0.05)
    raise TimeoutError(f"the peer driver did not report within {bound} s")


def _cluster_direct(cfg, dev, n):
    """The oracle: make_train_step in this driver on batches 0..n-1
    (inputs and labels shifted here). Returns the losses and step
    seconds."""
    from ray_tpu_torch import models as tm

    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, step_s = [], []
    for i in range(n):
        t = _cluster_batch(i, cfg.vocab_size, TRAIN_BATCH,
                           TRAIN_LEN + 1).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(step(t[:, :-1], t[:, 1:]).item())
        step_s.append(time.perf_counter() - t0)
    del params, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return losses, step_s


class _DagDraw:
    """Phase 20 (d)'s first stage: batch ``i`` (a seeded draw)."""

    def __init__(self, vocab, batch, length):
        self.shape = (vocab, batch, length)

    def draw(self, i):
        return (os.getpid(), _cluster_batch(i, *self.shape).numpy())


class _DagShift:
    """Phase 20 (d)'s second stage: the shift into inputs and labels."""

    def shift(self, drawn):
        pid, tokens = drawn
        return ([pid, os.getpid()], np.ascontiguousarray(tokens[:, :-1]),
                np.ascontiguousarray(tokens[:, 1:]))


def _await_relays(hc, bound):
    """Block until the head pushes to this client's event channel again
    (after a head restart): a probe topic this client subscribes to
    reaches one subscriber."""
    topic = "chip_smoke:relay_probe:" + hc.client_id
    sub = hc.subscribe(topic)
    deadline = time.monotonic() + bound
    try:
        while True:
            try:
                if hc.publish(topic, 0) >= 1:
                    return
            except ConnectionError:
                pass  # the head is not back yet
            if time.monotonic() > deadline:
                raise TimeoutError(f"the head did not relay to this driver "
                                   f"within {bound} s of its restart")
            time.sleep(0.05)
    finally:
        sub.close()


def _cluster_nop(x):
    return x + 1


def _cluster_dag(rt, cfg, dev, direct, tmp, draw, shift):
    """Phase 20 (d): the shm DAG over the process-backed actors ``draw``
    and ``shift`` feeds a fresh step; a traced task's worker span and the
    workers' flight bundles reach this driver."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.dag import InputNode

    checks, out = {}, {}
    with InputNode() as inp:
        dag = shift.shift.bind(draw.draw.bind(inp))
    compiled = dag.experimental_compile(
        backend="actor",
        channel_bytes=4 * TRAIN_BATCH * (TRAIN_LEN + 1) * 8)
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, pids = [], set()
    try:
        checks["d_shm_plane"] = bool(compiled._shm_mode)
        for i in range(CLUSTER_DAG_STEPS):
            stage_pids, inputs, labels = compiled.execute(i).get(
                timeout=CLUSTER_POLL_S)
            pids.update(stage_pids)
            losses.append(step(torch.from_numpy(inputs).to(dev),
                               torch.from_numpy(labels).to(dev)).item())
    finally:
        compiled.teardown()
    del params, step
    checks["d_stages_in_two_worker_processes"] = (
        len(pids) == 2 and os.getpid() not in pids)
    checks["d_losses_equal_thread_fed"] = (
        losses == direct[:CLUSTER_DAG_STEPS])
    out["d"] = {"losses": losses, "stage_pids": sorted(pids)}
    # A traced task: its worker.exec span, recorded in the worker
    # process, reaches timeline(trace_id) through the session's traces
    # directory.
    nop = rt.remote(_cluster_nop)
    with tracing.start_span("chip_smoke_cluster") as root:
        rt.get(nop.remote(1), timeout=CLUSTER_POLL_S)
    events = []
    deadline = time.monotonic() + CLUSTER_POLL_S
    while time.monotonic() < deadline:
        events = [e for e in rt.timeline(trace_id=root.ctx.trace_id)
                  if e.get("name") == "worker.exec"]
        if events:
            break
        time.sleep(0.05)
    checks["d_worker_span_in_timeline"] = bool(events) and all(
        e["pid"] != os.getpid() for e in events)
    incident = rt.debug_dump(os.path.join(tmp, "dump"))
    with open(os.path.join(incident, "manifest.json")) as fh:
        manifest = json.load(fh)
    driver = manifest["sources"].get("driver", {})
    checks["d_worker_bundles_in_debug_dump"] = (
        driver.get("num_workers", 0) >= 1
        and "head" in manifest["sources"])
    out["d"].update(worker_spans=len(events),
                    dump_sources=sorted(manifest["sources"]),
                    worker_bundles=driver.get("num_workers", 0))
    return checks, out


def _p99(xs):
    xs = sorted(xs)
    return xs[min(int(0.99 * len(xs)), len(xs) - 1)] if xs else None


def phase_cluster(dev, card, cfg):
    """Phase 20 (module docstring). The peers' boots overlap the work
    before them: the first peer starts with the head (it waits for the
    trainer's name), the second before the failures of (c) (it waits for
    a key to step after the head's restart), and (d)'s actors spawn while
    (c) waits for the dead peer to leave."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.worker import ObjectRef
    from ray_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    L = cfg.n_layers
    fa = _flash_module()
    checks, out, readings, part_s = {}, {}, {}, {}
    t0 = time.perf_counter()
    if dev.type == "cuda":   # both at once (built already in the script)
        _build.build_all(("flash_attention_fwd_wgmma",
                          "flash_attention_bwd_wgmma"))
    part_s["build"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    state = os.path.join(tmp, "head_state.log")
    # Tracing and the flight recorder armed for the head, the drivers
    # and the worker processes (the environment inherits).
    armed = {k: os.environ.get(k) for k in (
        "RAY_TPU_TRACE", "RAY_TPU_FLIGHT")}
    os.environ["RAY_TPU_TRACE"] = os.environ["RAY_TPU_FLIGHT"] = "1"
    head_env = _cluster_env(
        RAY_TPU_HEAD_CLIENT_TIMEOUT_S=str(CLUSTER_CLIENT_TIMEOUT_S))
    peer = peer2 = head = head2 = None
    rt.shutdown()
    try:
        t0 = time.perf_counter()
        head, address, readings["head_boot_s"] = _start_head(
            state, env=head_env)
        port = int(address.rsplit(":", 1)[1])
        key = "chip_smoke/cluster/peer"
        spec = {"address": address, "actor": CLUSTER_ACTOR,
                "topic": CLUSTER_TOPIC, "key": key,
                "steps": CLUSTER_STEPS, "relay_calls": CLUSTER_RELAY_CALLS,
                "vocab": cfg.vocab_size, "batch": TRAIN_BATCH,
                "length": TRAIN_LEN + 1, "pull_bytes": CLUSTER_PULL_BYTES,
                "poll_s": CLUSTER_POLL_S, "hold_s": 4 * CLUSTER_POLL_S}
        peer = _start_peer(spec)
        # The oracle: the direct loop, one step more than the relay's.
        direct, direct_s = _cluster_direct(cfg, dev, CLUSTER_STEPS + 1)
        part_s["direct"] = time.perf_counter() - t0
        # (a) + (b): the peer drives the trainer through the head.
        t0 = time.perf_counter()
        w = rt.init(num_cpus=4, worker_mode="process", address=address)
        _zero_counts()
        plain = fa.plain_routes
        trainer = rt.remote(runtime="driver")(_ClusterTrainer).options(
            name=CLUSTER_ACTOR).remote(cfg, dev, CLUSTER_TOPIC)
        got = _wait_json(w, key, peer, 4 * CLUSTER_POLL_S)
        counts, plain_t = _counts(), fa.plain_routes - plain
        if "error" in got:
            raise AssertionError(f"phase 20's peer failed:\n{got['error']}")
        losses = got["losses"]
        want = _want_counts("wgmma", CLUSTER_STEPS * L, CLUSTER_STEPS * L)
        checks["a_handle_is_cross_driver"] = (
            got["handle"] == "CrossDriverActorHandle")
        checks["a_losses_bit_equal_direct"] = (
            losses == direct[:CLUSTER_STEPS])
        checks["a_launches_per_step"] = counts == want
        checks["a_plain_routes_0"] = plain_t == 0
        checks["a_peer_never_initialised_cuda"] = (
            not got["cuda_initialized"] and not got["cuda_available"]
            and got["visible"] == "")
        checks["b_messages_in_order"] = got["msgs"] == [
            [i, loss] for i, loss in enumerate(losses)]
        out["a"] = {"losses": losses, "direct_losses": direct,
                    "launches_per_step": {k: v / CLUSTER_STEPS
                                          for k, v in counts.items() if v},
                    "plain_routes": plain_t, "peer_pid": got["pid"]}
        actor_s = rt.get(trainer.step_seconds.remote(),
                         timeout=CLUSTER_POLL_S)
        readings.update({
            "relay_round_trip_ms_p50": _p50(got["trips_s"]) * 1e3,
            "relay_round_trip_ms_p99": _p99(got["trips_s"]) * 1e3,
            "relayed_step_ms_p50_at_peer": _p50(got["step_s"][1:]) * 1e3,
            "relayed_step_ms_p50_in_actor": _p50(actor_s[1:]) * 1e3,
            "direct_step_ms_p50": _p50(direct_s[1:]) * 1e3,
            "relayed_step_ms_at_peer": [x * 1e3 for x in got["step_s"]]})
        # The 64 MiB object, pulled from the peer's object server.
        t1 = time.perf_counter()
        big = rt.get(ObjectRef(ObjectID.from_hex(got["big_oid"])),
                     timeout=CLUSTER_POLL_S)
        pull_s = time.perf_counter() - t1
        checks["a_big_object_equal"] = (
            big.nbytes == CLUSTER_PULL_BYTES
            and int(big.sum(dtype=np.int64)) == got["big_sum"])
        readings["pull_64MiB_GBps"] = CLUSTER_PULL_BYTES / pull_s / 1e9
        del big
        part_s["a"] = time.perf_counter() - t0
        # (c) The second peer boots (it steps after the head's restart),
        # and (d)'s stage actors spawn, while the first peer dies: its
        # client leaves cluster_info within the head's client timeout,
        # and the trainer still answers here.
        t0 = time.perf_counter()
        key2 = key + "/after_restart"
        peer2 = _start_peer(dict(spec, key=key2, first=CLUSTER_STEPS,
                                 steps=1, relay_calls=0, pull_bytes=0,
                                 go=key2 + "/go"))
        draw = rt.remote(_DagDraw).remote(cfg.vocab_size, TRAIN_BATCH,
                                          TRAIN_LEN + 1)
        shift = rt.remote(_DagShift).remote()
        hc = w.head_client
        peer.send_signal(signal.SIGKILL)
        peer.wait(timeout=CLUSTER_POLL_S)
        t1 = time.monotonic()
        gone = False
        while time.monotonic() - t1 < CLUSTER_CLIENT_TIMEOUT_S + 3.0:
            if got["client"] not in hc.cluster_info()["clients"]:
                gone = True
                break
            time.sleep(0.1)
        readings["dead_peer_gone_s"] = time.monotonic() - t1
        checks["c_dead_peer_leaves_cluster_info"] = gone
        checks["c_trainer_answers_after_peer_kill"] = rt.get(
            trainer.ping.remote(), timeout=CLUSTER_POLL_S) == CLUSTER_STEPS
        # The head dies (once the second peer is attached) and restarts
        # on its port and state log; this driver's client reconnects and
        # the head resolves the trainer to it again; the second peer,
        # reconnected too, resolves it through the new head and steps
        # batch CLUSTER_STEPS.
        _wait_json(w, key2 + "/attached", peer2, 4 * CLUSTER_POLL_S)
        head.send_signal(signal.SIGKILL)
        head.wait(timeout=CLUSTER_POLL_S)
        t1 = time.perf_counter()
        head2, _, readings["head_restart_boot_s"] = _start_head(
            state, port=port, env=head_env)
        entry = None
        deadline = time.monotonic() + CLUSTER_POLL_S
        while entry is None and time.monotonic() < deadline:
            try:
                entry = hc.actor_lookup("default", CLUSTER_ACTOR)
            except ConnectionError:
                time.sleep(0.1)
        readings["head_reresolve_s"] = time.perf_counter() - t1
        checks["c_head_resolves_trainer_after_restart"] = (
            entry is not None and entry[0] == hc.client_id)
        # The request channel answers first; a relay to this driver needs
        # its event channel too, re-dialled on its own 0.5 s cadence.
        _await_relays(hc, CLUSTER_POLL_S)
        readings["head_relays_back_s"] = time.perf_counter() - t1
        w.kv_put((key2 + "/go").encode(), b"1")
        got2 = _wait_json(w, key2, peer2, 4 * CLUSTER_POLL_S)
        if "error" in got2:
            raise AssertionError(
                f"phase 20's second peer failed:\n{got2['error']}")
        readings["second_peer_step_after_restart_s"] = (
            time.perf_counter() - t1)
        loss25 = got2["losses"][0]
        checks["c_step_after_restart_equals_direct"] = (
            loss25 == direct[CLUSTER_STEPS])
        checks["c_second_peer_message"] = got2["msgs"] == [
            [CLUSTER_STEPS, loss25]]
        checks["c_head_epoch_2"] = hc.head_epoch == 2
        out["c"] = {"loss_after_restart": loss25, "epoch": hc.head_epoch}
        w.kv_put((key2 + "/done").encode(), b"1")
        peer2.wait(timeout=CLUSTER_POLL_S)
        rt.kill(trainer)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        part_s["c"] = time.perf_counter() - t0
        # (d) The shm DAG; the workers' spans and bundles.
        t0 = time.perf_counter()
        c, d_out = _cluster_dag(rt, cfg, dev, direct, tmp, draw, shift)
        checks.update(c)
        out.update(d_out)
        part_s["d"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
        for k, v in armed.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for proc in (peer, peer2, head, head2):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "phase": "cluster", "config": {
            "d_model": cfg.d_model, "n_layers": L,
            "dtype": _dtype_name(cfg.dtype),
            "train_batch": [TRAIN_BATCH, TRAIN_LEN],
            "steps": CLUSTER_STEPS, "dag_steps": CLUSTER_DAG_STEPS,
            "client_timeout_s": CLUSTER_CLIENT_TIMEOUT_S},
        "checks": checks, **out, "readings": readings, "part_s": part_s,
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 20 (cluster) failed {failed}")
    return result


# ------------------------------------------------------------ phase 21
def _shipped(obj):
    """``obj`` as the importable module ``chip_smoke`` holds it: run as a
    script, this module is ``__main__``, whose functions and classes
    cloudpickle would copy by value into the payloads a node receives;
    the module's own are sent by reference (node daemons import it)."""
    if __name__ != "__main__":
        return obj
    return getattr(importlib.import_module("chip_smoke"), obj.__name__)


def _node_batch(i, vocab, batch, length):
    """Phase 21's batch ``i``: [batch, length] seeded int64 tokens on the
    CPU (inputs are ``[:, :-1]``, labels ``[:, 1:]``)."""
    rng = np.random.default_rng(SEED + 21_000 + i)
    return torch.from_numpy(rng.integers(0, vocab, (batch, length)))


def _node_feed(i, vocab, batch, length, delay_s=0.0):
    """Phase 21's feed task (on a feed node): batch ``i`` as a host
    tensor, with the pid that made it."""
    if delay_s:
        time.sleep(delay_s)
    return os.getpid(), _node_batch(i, vocab, batch, length)


def _node_big(n):
    """A seeded ``n``-byte array, made on the node the task runs on."""
    return np.random.default_rng(SEED + 21_001).integers(
        0, 256, n, dtype=np.uint8)


def _node_pull(wrapped):
    """Runs on a card node: pull the object behind ``wrapped[0]`` (a ref
    nested in a list, so it arrives unresolved) and time the pull."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    arr = rt.get(wrapped[0], timeout=NODE_POLL_S)
    seconds = time.perf_counter() - t0
    return int(arr.nbytes), int(arr.sum(dtype=np.int64)), seconds


class _NodeTrainer:
    """Phase 21's placed actor: make_train_step on its process's
    ``dev``, which must be there (a card node's daemon owns ``cuda:0``).
    ``step`` takes a feed task's ``(pid, tokens)``; ``report`` returns
    the launch counts and plain routes counted in this process since
    ``reset``, the feed pids, the step seconds and the construction's
    seconds (``init_s``), split into the parameters on ``dev`` and
    ``make_train_step`` (whose AdamW imports torch's compiler stack the
    first time in a process)."""

    def __init__(self, cfg, dev, params=None):
        from ray_tpu_torch import models as tm

        t0 = time.perf_counter()
        self.dev = torch.device(dev)
        if self.dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("the trainer was placed on a node that "
                                   "sees no card")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = (params if params is not None
                       else tm.init_params(cfg, SEED, device=self.dev))
        t1 = time.perf_counter()
        self.step_fn = tm.make_train_step(cfg, self.params)
        self.reset()
        self.init_s = time.perf_counter() - t0
        self.init_split_s = {"params": t1 - t0,
                             "train_step": self.init_s - (t1 - t0)}

    def reset(self):
        self.feed_pids, self.step_s = [], []
        self.plain0 = 0
        if self.dev.type == "cuda":
            _zero_counts()
            self.plain0 = _flash_module().plain_routes
        return os.getpid()

    def step(self, fed):
        pid, tokens = fed
        t = torch.as_tensor(tokens).to(self.dev)
        _sync(self.dev)
        t0 = time.perf_counter()
        loss = self.step_fn(t[:, :-1], t[:, 1:]).item()
        self.step_s.append(time.perf_counter() - t0)
        self.feed_pids.append(pid)
        return loss

    def hold(self, seconds):
        time.sleep(seconds)
        return os.getpid()

    def report(self):
        out = {"pid": os.getpid(), "device": str(self.dev),
               "init_s": self.init_s, "init_split_s": self.init_split_s,
               "feed_pids": list(self.feed_pids),
               "step_s": list(self.step_s),
               "cuda_initialized": torch.cuda.is_initialized()}
        if self.dev.type == "cuda":
            out["counts"] = _counts()
            out["plain_routes"] = _flash_module().plain_routes - self.plain0
        return out


def _node_peer(spec_json: str) -> int:
    """Phase 21 (b)'s thin client (a subprocess: ``python -c "import
    chip_smoke, sys; sys.exit(chip_smoke._node_peer(sys.argv[1]))"
    SPEC``). It attaches with ``ray://``, waits for the go key, resolves
    spec["actor"], then steps spec["steps"] batches from spec["first"]
    on, each made by its own feed task; its results go to the KV under
    spec["key"] as JSON."""
    import traceback

    import ray_tpu_torch as rt

    spec = json.loads(spec_json)
    w = rt.init(address="ray://" + spec["address"])
    out = {"pid": os.getpid(), "client": w.head_client.client_id}
    poll = spec["poll_s"]
    try:
        # The go key comes once the trainer is placed: resolved before,
        # its name would find no placement yet and relay through the
        # owning driver (CrossDriverActorHandle).
        deadline = time.monotonic() + 4 * poll
        while w.kv_get(spec["go"].encode()) is None:
            if time.monotonic() > deadline:
                raise TimeoutError("no go key")
            time.sleep(0.05)
        trainer = rt.get_actor(spec["actor"])
        out["handle"] = type(trainer).__name__
        feed = rt.remote(_shipped(_node_feed)).options(
            resources={"feed": 1})
        losses, step_s, fed_by = [], [], []
        for i in range(spec["first"], spec["first"] + spec["steps"]):
            ref = feed.remote(i, spec["vocab"], spec["batch"],
                              spec["length"])
            fed_by.append(w.borrowed_owner(ref.object_id.binary()) is None
                          and w.remote_router.handles(ref.object_id))
            t0 = time.perf_counter()
            losses.append(rt.get(trainer.step.remote(ref), timeout=poll))
            step_s.append(time.perf_counter() - t0)
        out.update(losses=losses, step_s=step_s, owns_feed_refs=all(fed_by),
                   cpus=w.resource_pool.total.get("CPU", 0.0),
                   client_mode=w.client_mode,
                   cuda_initialized=torch.cuda.is_initialized(),
                   cuda_available=torch.cuda.is_available(),
                   visible=os.environ.get("CUDA_VISIBLE_DEVICES"))
    except BaseException:  # noqa: BLE001 — reported to the smoke driver
        out["error"] = traceback.format_exc()
    w.kv_put(spec["key"].encode(), json.dumps(out).encode())
    rt.shutdown()
    return 0 if "error" not in out else 1


def _spawn_daemons(address, specs, env_of):
    """Start one node daemon per ``(name, num_cpus, resources, mode)``,
    all at once: ({name: process}, {name: spawn time})."""
    procs, t0 = {}, {}
    for name, num_cpus, resources, mode in specs:
        t0[name] = time.perf_counter()
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
             "--address", address, "--num-cpus", str(num_cpus),
             "--resources", json.dumps(resources), "--worker-mode", mode],
            stdout=subprocess.PIPE, text=True, env=env_of(name))
    return procs, t0


def _await_joined(procs, t0):
    """Read each daemon's joined line, all within NODE_JOIN_S of now:
    ({name: seconds from spawn to the line}, [names that did not
    join]). A daemon that prints anything else raises."""
    import selectors

    joined, deadline = {}, time.monotonic() + NODE_JOIN_S
    with selectors.DefaultSelector() as sel:
        for name, p in procs.items():
            sel.register(p.stdout, selectors.EVENT_READ, name)
        while len(joined) < len(procs):
            ready = sel.select(timeout=max(deadline - time.monotonic(), 0))
            if not ready:
                break
            for key, _ in ready:
                name = key.data
                line = procs[name].stdout.readline()
                sel.unregister(key.fileobj)
                if "joined" not in line:
                    raise RuntimeError(f"node daemon {name} did not join: "
                                       f"{line!r}")
                joined[name] = time.perf_counter() - t0[name]
    return joined, sorted(set(procs) - set(joined))


def _start_daemons(address, specs, env_of):
    """Spawn the daemons at once and wait for their joined lines:
    (processes, join seconds, names that did not join)."""
    procs, t0 = _spawn_daemons(address, specs, env_of)
    joined, missing = _await_joined(procs, t0)
    return procs, joined, missing


def _node_warm():
    """Runs on a card node: create its CUDA context and a cuBLAS handle
    and load the flash kernels' libraries (no kernel launches), so that
    an actor started there later starts warm."""
    from ray_tpu_torch.ops import _build

    x = torch.ones(64, 64, device="cuda")
    (x @ x).sum().item()
    for name in ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma"):
        _build.load_library(name)
    return os.getpid()


def _node_import_warm(seconds):
    """Runs on a feed node's worker: this module (and torch) imported,
    then held ``seconds`` so that the node's other worker takes the
    next one."""
    time.sleep(seconds)
    return os.getpid()


def _ppid(pid: int) -> int:
    """The parent pid of a live process (0 when it is gone)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return int(fh.read().rsplit(")", 1)[1].split()[1])
    except (OSError, IndexError, ValueError):
        return 0


def _node_direct(cfg, dev, n, batch_of=None):
    """The oracle: make_train_step in this driver on phase 21's batches
    0..n-1 (``batch_of``'s, when given). Returns the losses and step
    seconds."""
    from ray_tpu_torch import models as tm

    batch_of = batch_of or _node_batch
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, step_s = [], []
    for i in range(n):
        t = batch_of(i, cfg.vocab_size, TRAIN_BATCH,
                     TRAIN_LEN + 1).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(step(t[:, :-1], t[:, 1:]).item())
        step_s.append(time.perf_counter() - t0)
    del params, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return losses, step_s


def _node_rec(w, name):
    """Daemon ``name``'s membership record (found by its resources)."""
    res = {"A": "card_a", "B": "card_b", "F1": "feed_1", "F2": "feed_2",
           "T": "traced"}[name]
    for n in w.head_client.node_list():
        if res in (n.get("resources") or {}):
            return n
    raise RuntimeError(f"daemon {name} is not in the membership")


def _node_failures(rt, w, cfg, procs, trainer, direct, node_of, checks,
                   readings, out):
    """Phase 21 (c): SIGKILL feed node F1 under a wave of feed tasks, then
    the card node that hosts the trainer."""
    feed = rt.remote(_shipped(_node_feed)).options(
        resources={"feed": 1})
    first = NODE_STEPS + NODE_PEER_STEPS
    wave = [feed.remote(first + k, cfg.vocab_size, TRAIN_BATCH,
                        TRAIN_LEN + 1, 0.5) for k in range(NODE_WAVE)]
    time.sleep(0.2)   # the wave's first tasks are running on F1 and F2
    t_kill = time.perf_counter()
    procs["F1"].kill()
    procs["F1"].wait(timeout=10)
    fed = rt.get(wave, timeout=NODE_POLL_S)
    readings["f1_kill_to_wave_s"] = time.perf_counter() - t_kill
    checks["c_wave_arrived_intact"] = all(
        torch.equal(t, _node_batch(first + k, cfg.vocab_size, TRAIN_BATCH,
                                   TRAIN_LEN + 1))
        for k, (_, t) in enumerate(fed))
    loss = rt.get(trainer.step.remote(wave[0]), timeout=NODE_POLL_S)
    checks["c_step_after_f1_kill_equals_direct"] = loss == direct[first]
    # The card node that hosts the trainer.
    host = node_of["trainer"]
    other = "B" if host == "A" else "A"
    held = trainer.hold.remote(30.0)
    time.sleep(0.5)   # the call is running on the host
    t_kill = time.perf_counter()
    procs[host].kill()
    procs[host].wait(timeout=10)
    try:
        rt.get(held, timeout=NODE_POLL_S)
        died = "no error"
    except Exception as exc:  # noqa: BLE001 — the expected death
        died = type(exc).__name__
    checks["c_inflight_call_actor_died"] = died == "ActorDiedError"
    other_client = node_of[other + "_client"]
    deadline = time.monotonic() + NODE_POLL_S
    rec = None
    while time.monotonic() < deadline:
        rec = w.head_client.actor_locate(trainer._actor_id.binary())
        if rec is not None and rec.get("alive") \
                and rec.get("node") == other_client:
            break
        time.sleep(0.05)
    checks["c_restarted_on_other_card_node"] = (
        rec is not None and rec.get("node") == other_client)
    feed2 = [feed.remote(i, cfg.vocab_size, TRAIN_BATCH, TRAIN_LEN + 1)
             for i in range(NODE_RESTART_STEPS)]
    rt.get(trainer.reset.remote(), timeout=NODE_POLL_S)
    losses = []
    for i in range(NODE_RESTART_STEPS):
        losses.append(rt.get(trainer.step.remote(feed2[i]),
                             timeout=NODE_POLL_S))
        if i == 0:
            readings["card_kill_to_restarted_step_s"] = (
                time.perf_counter() - t_kill)
    rep = rt.get(trainer.report.remote(), timeout=NODE_POLL_S)
    L = cfg.n_layers
    checks["c_restarted_losses_equal_direct_first"] = (
        losses == direct[:NODE_RESTART_STEPS])
    checks["c_restarted_in_other_card_node"] = (
        rep["pid"] == procs[other].pid and rep["device"] == node_of["dev"])
    checks["c_restarted_launches"] = rep.get("counts") == _want_counts(
        "wgmma", NODE_RESTART_STEPS * L, NODE_RESTART_STEPS * L)
    checks["c_restarted_plain_routes_0"] = rep.get("plain_routes") == 0
    out["c"] = {"restart_losses": losses, "died": died, "host": host,
                "restarted_on": other}
    return other


def _node_observe(rt, w, trainer, vocab, clients, trace_ctx, checks, out):
    """Phase 21 (d): a traced feed + step reach this driver's timeline
    from the feed and card nodes (``clients["feed"]``, ``["card"]``);
    debug_dump and cluster_metrics hold every live daemon; the daemon
    launched under RAY_TPU_TRACE_PARENT (``clients["traced"]``) shows its
    node.init span in that trace."""
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.util import state

    feed_node, card_node = clients["feed"], clients["card"]
    feed = rt.remote(_shipped(_node_feed)).options(
        resources={"feed": 1})
    with tracing.start_span("smoke.nodes") as span:
        ref = feed.remote(0, vocab, TRAIN_BATCH, TRAIN_LEN + 1)
        rt.get(trainer.step.remote(ref), timeout=NODE_POLL_S)
    spans = []
    deadline = time.monotonic() + NODE_POLL_S
    while time.monotonic() < deadline:
        spans = rt.timeline(trace_id=span.ctx.trace_id)
        by_node = {}
        for e in spans:
            args = e.get("args") or {}
            by_node.setdefault(args.get("node", ""), set()).add(e["name"])
        if card_node in by_node and feed_node in by_node:
            break
        time.sleep(0.2)
    checks["d_timeline_has_card_node_spans"] = card_node in by_node
    checks["d_timeline_has_feed_node_spans"] = feed_node in by_node
    out["d"] = {"span_names_by_node": {k: sorted(v)
                                       for k, v in by_node.items()}}
    incident = rt.debug_dump()
    with open(os.path.join(incident, "manifest.json")) as fh:
        manifest = json.load(fh)
    sources = set(manifest["sources"])
    live_clients = {n["client_id"] for n in w.head_client.node_list()
                    if n.get("alive")}
    checks["d_debug_dump_every_live_daemon"] = (
        {f"node-{c}" for c in live_clients} <= sources)
    text = state.cluster_metrics()
    checks["d_cluster_metrics_every_live_daemon"] = all(
        f'node="{c}"' in text for c in live_clients)
    shutil.rmtree(incident, ignore_errors=True)
    init_spans = [s for s in state.collect_trace_spans(trace_ctx.trace_id)
                  if s.get("name") == "node.init"]
    checks["d_cold_start_node_init_span"] = (
        len(init_spans) == 1
        and init_spans[0].get("parent_id") == trace_ctx.span_id
        and init_spans[0].get("node") == clients["traced"])
    out["d"].update(sources=sorted(sources),
                    live_daemons=sorted(live_clients),
                    node_init_spans=len(init_spans))


def phase_nodes(dev, card, cfg):
    """Phase 21 (module docstring). The five daemons boot at once; the
    thin client starts with them and waits for the trainer's name and a
    go key."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import tracing
    from ray_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    L = cfg.n_layers
    checks, out, readings, part_s = {}, {}, {}, {}
    t0 = time.perf_counter()
    if dev.type == "cuda":   # both at once (built already in the script)
        _build.build_all(("flash_attention_fwd_wgmma",
                          "flash_attention_bwd_wgmma"))
    part_s["build"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nodes_")
    armed = {k: os.environ.get(k) for k in (
        "RAY_TPU_TRACE", "RAY_TPU_FLIGHT")}
    os.environ["RAY_TPU_TRACE"] = os.environ["RAY_TPU_FLIGHT"] = "1"
    base_env = _cluster_env(
        RAY_TPU_HEAD_CLIENT_TIMEOUT_S=str(NODE_CLIENT_TIMEOUT_S))
    # The cold-start parent a launched daemon inherits (its node.init
    # span joins this trace).
    trace_ctx = tracing.TraceContext(os.urandom(16).hex(),
                                     os.urandom(8).hex())

    def env_of(name):
        env = dict(base_env)
        if name in ("F1", "F2", "T"):
            env["CUDA_VISIBLE_DEVICES"] = ""
        if name == "T":
            env[tracing.ENV_PARENT] = tracing.encode_cold_start_parent(
                trace_ctx)
        return env

    head = peer = None
    procs = {}
    rt.shutdown()
    try:
        t0 = time.perf_counter()
        head, address, readings["head_boot_s"] = _start_head(
            os.path.join(tmp, "head_state.log"), env=base_env)
        procs, spawned = _spawn_daemons(address, [
            ("A", 2, {"card_a": 1}, "thread"),
            ("B", 2, {"card_b": 1}, "thread"),
            ("F1", 2, {"feed": 1, "feed_1": 1}, "process"),
            ("F2", 2, {"feed": 1, "feed_2": 1}, "process"),
            ("T", 1, {"traced": 1}, "thread")], env_of)
        key = "chip_smoke/nodes/peer"
        peer = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke._node_peer(sys.argv[1]))",
             json.dumps({"address": address, "actor": NODE_ACTOR,
                         "key": key, "go": key + "/go",
                         "first": NODE_STEPS, "steps": NODE_PEER_STEPS,
                         "vocab": cfg.vocab_size, "batch": TRAIN_BATCH,
                         "length": TRAIN_LEN + 1,
                         "poll_s": NODE_POLL_S})],
            env=_cluster_env(CUDA_VISIBLE_DEVICES=""))
        # This driver attaches now: the warm-ups below park until their
        # node joins, and run while the oracle does. Each card node gets
        # its CUDA context, cuBLAS and the kernels' libraries (the
        # restart of (c) finds the other one warm); each feed node's two
        # workers import this module.
        w = rt.init(num_cpus=0, num_gpus=0, address=address)
        warm_card = [rt.remote(_shipped(_node_warm)).options(
            resources={res: 0.01}).remote() for res in ("card_a", "card_b")]
        warm_feed = [rt.remote(_shipped(_node_import_warm)).options(
            resources={res: 0.01}).remote(1.0)
            for res in ("feed_1", "feed_2") for _ in range(2)]
        # The oracle runs while the daemons boot; a thread reads their
        # joined lines as they come.
        boot = {}
        reader = threading.Thread(
            target=lambda: boot.update(
                zip(("joined", "missing"), _await_joined(procs, spawned))),
            daemon=True)
        reader.start()
        t1 = time.perf_counter()
        n_direct = NODE_STEPS + NODE_PEER_STEPS + 1
        direct, direct_s = _node_direct(cfg, dev, n_direct)
        part_s["direct"] = time.perf_counter() - t1
        reader.join(NODE_JOIN_S + 5)
        if "joined" not in boot:
            raise AssertionError("the node daemons' joined lines were not "
                                 "read")
        joined, missing = boot["joined"], boot["missing"]
        if missing:
            raise AssertionError(f"node daemons {missing} did not join "
                                 f"within {NODE_JOIN_S} s")
        readings["daemon_boot_s"] = joined
        part_s["boot_and_direct"] = time.perf_counter() - t0
        # (a) the trainer, placed by the router on a card node.
        t0 = time.perf_counter()
        node_of = {"dev": str(dev)}
        for name in procs:
            node_of[name + "_client"] = _node_rec(w, name)[
                "client_id"]
        checks["a_card_nodes_advertise_gpu"] = all(
            _node_rec(w, n)["resources"].get("GPU") == 1.0
            for n in ("A", "B"))
        checks["a_feed_nodes_advertise_no_gpu"] = not any(
            _node_rec(w, n)["resources"].get("GPU")
            for n in ("F1", "F2", "T"))
        trainer = rt.remote(_shipped(_NodeTrainer)).options(
            name=NODE_ACTOR, num_gpus=1, max_restarts=1).remote(cfg,
                                                                str(dev))
        rt.get(trainer.reset.remote(), timeout=NODE_POLL_S)
        readings["trainer_ready_s"] = time.perf_counter() - t0
        checks["a_card_nodes_warm"] = sorted(
            rt.get(warm_card, timeout=NODE_POLL_S)) == sorted(
            (procs["A"].pid, procs["B"].pid))
        checks["a_feed_nodes_warm"] = {
            _ppid(p) for p in rt.get(warm_feed, timeout=NODE_POLL_S)} == {
            procs["F1"].pid, procs["F2"].pid}
        rec = w.head_client.actor_locate(trainer._actor_id.binary())
        host = next((n for n in ("A", "B")
                     if rec and rec.get("node") == node_of[n + "_client"]),
                    None)
        node_of["trainer"] = host
        checks["a_trainer_placed_on_a_card_node"] = host is not None
        feed = rt.remote(_shipped(_node_feed)).options(
            resources={"feed": 1})
        router = w.remote_router
        losses, relayed_after_first = [], None
        for i in range(NODE_STEPS):
            ref = feed.remote(i, cfg.vocab_size, TRAIN_BATCH, TRAIN_LEN + 1)
            losses.append(rt.get(trainer.step.remote(ref),
                                 timeout=NODE_POLL_S))
            if i == 0:
                relayed_after_first = router.relayed_pushes
        rep = rt.get(trainer.report.remote(), timeout=NODE_POLL_S)
        want = _want_counts("wgmma", NODE_STEPS * L, NODE_STEPS * L)
        checks["a_losses_bit_equal_direct"] = losses == direct[:NODE_STEPS]
        checks["a_launches_in_card_node"] = rep.get("counts") == want
        checks["a_plain_routes_0"] = rep.get("plain_routes") == 0
        checks["a_trainer_runs_in_card_node_daemon"] = (
            host is not None and rep["pid"] == procs[host].pid
            and rep["device"] == str(dev))
        # Feed nodes run the process plane: their tasks run in worker
        # processes whose parent is the F1 or F2 daemon.
        feed_pids = set(rep["feed_pids"])
        checks["a_feed_tasks_on_feed_nodes"] = bool(feed_pids) and all(
            _ppid(p) in (procs["F1"].pid, procs["F2"].pid)
            for p in feed_pids)
        checks["a_no_relayed_push_after_first_wave"] = (
            router.relayed_pushes == relayed_after_first)
        out["a"] = {"losses": losses, "direct_losses": direct,
                    "host": host, "feed_pids": sorted(feed_pids),
                    "launches_per_step": {
                        k: v / NODE_STEPS
                        for k, v in rep.get("counts", {}).items() if v},
                    "plain_routes": rep.get("plain_routes"),
                    "direct_pushes": router.direct_pushes,
                    "relayed_pushes": router.relayed_pushes}
        readings["step_ms_p50_placed_actor"] = _p50(rep["step_s"][1:]) * 1e3
        readings["step_ms_p50_direct"] = _p50(direct_s[1:]) * 1e3
        nop = rt.remote(_shipped(_cluster_nop)).options(
            resources={"feed": 1})
        rt.get(nop.remote(0), timeout=NODE_POLL_S)
        trips = []
        for i in range(NODE_TRIPS):
            t1 = time.perf_counter()
            rt.get(nop.remote(i), timeout=NODE_POLL_S)
            trips.append(time.perf_counter() - t1)
        readings["task_round_trip_ms_p50"] = _p50(trips) * 1e3
        readings["task_round_trip_ms_p99"] = _p99(trips) * 1e3
        strategies = importlib.import_module(
            "ray_tpu_torch.util.scheduling_strategies")
        f1_id = _node_rec(w, "F1")["node_id"]
        a_id = _node_rec(w, host)["node_id"]
        big = rt.remote(_shipped(_node_big)).options(
            scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
                f1_id)).remote(NODE_PULL_BYTES)
        # Wait for the object without pulling it here: the card node
        # must find it on F1.
        done = router._done.get(big.object_id.task_id())
        if done is None or not done.wait(NODE_POLL_S):
            raise AssertionError("the 64 MiB object was never made on F1")
        puller = rt.remote(_shipped(_node_pull))
        nbytes, total, pull_s = rt.get(puller.options(
            scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
                a_id)).remote([big]), timeout=NODE_POLL_S)
        checks["a_pull_intact"] = (
            nbytes == NODE_PULL_BYTES
            and total == int(_node_big(NODE_PULL_BYTES).sum(dtype=np.int64)))
        readings["pull_64mib_f1_to_card_gbps"] = nbytes / pull_s / 1e9
        part_s["a"] = time.perf_counter() - t0
        # (b) the thin client steps the same trainer.
        t0 = time.perf_counter()
        w.kv_put((key + "/go").encode(), b"1")
        got = _wait_json(w, key, peer, 4 * NODE_POLL_S)
        if "error" in got:
            raise AssertionError(f"phase 21's thin client failed:\n"
                                 f"{got['error']}")
        checks["b_losses_bit_equal_direct"] = got["losses"] == direct[
            NODE_STEPS:NODE_STEPS + NODE_PEER_STEPS]
        checks["b_client_mode_no_cpu"] = (got["client_mode"]
                                          and got["cpus"] == 0.0)
        checks["b_client_owns_its_feed_refs"] = got["owns_feed_refs"]
        checks["b_client_never_initialised_cuda"] = (
            not got["cuda_initialized"] and not got["cuda_available"]
            and got["visible"] == "")
        checks["b_handle_is_placed_actor"] = got["handle"] == "ActorHandle"
        rep = rt.get(trainer.report.remote(), timeout=NODE_POLL_S)
        n_ab = NODE_STEPS + NODE_PEER_STEPS
        checks["b_launches_in_card_node"] = rep.get(
            "counts") == _want_counts("wgmma", n_ab * L, n_ab * L)
        out["b"] = {"losses": got["losses"], "peer_pid": got["pid"]}
        readings["step_ms_p50_thin_client"] = _p50(got["step_s"][1:]) * 1e3
        part_s["b"] = time.perf_counter() - t0
        # (c) failures.
        t0 = time.perf_counter()
        other = _node_failures(rt, w, cfg, procs, trainer, direct, node_of,
                               checks, readings, out)
        part_s["c"] = time.perf_counter() - t0
        # (d) observability over the live daemons (B or A, F2, T).
        t0 = time.perf_counter()
        _node_observe(rt, w, trainer, cfg.vocab_size, {
            "feed": node_of["F2_client"], "card": node_of[other + "_client"],
            "traced": node_of["T_client"]}, trace_ctx, checks, out)
        part_s["d"] = time.perf_counter() - t0
    finally:
        rt.shutdown()
        for k, v in armed.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for proc in [peer, head, *procs.values()]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "phase": "nodes", "config": {
            "d_model": cfg.d_model, "n_layers": L,
            "dtype": _dtype_name(cfg.dtype),
            "train_batch": [TRAIN_BATCH, TRAIN_LEN],
            "steps": NODE_STEPS, "peer_steps": NODE_PEER_STEPS,
            "restart_steps": NODE_RESTART_STEPS,
            "client_timeout_s": NODE_CLIENT_TIMEOUT_S},
        "checks": checks, **out, "readings": readings, "part_s": part_s,
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 21 (nodes) failed {failed}")
    return result


# ------------------------------------------------------------ phase 22
def _elastic_batch(i, vocab, batch, length):
    """Phase 22's batch ``i``: [batch, length] seeded int64 tokens on the
    CPU (inputs are ``[:, :-1]``, labels ``[:, 1:]``)."""
    rng = np.random.default_rng(SEED + 22_000 + i)
    return torch.from_numpy(rng.integers(0, vocab, (batch, length)))


def _elastic_feed(i, vocab, batch, length):
    """Phase 22's feed task (on an autoscaled feed node, under a
    runtime_env): its pid, the FEED_TAG it read, and batch ``i``."""
    return (os.getpid(), os.environ.get("FEED_TAG"),
            _elastic_batch(i, vocab, batch, length))


class _ElasticTrainer(_NodeTrainer):
    """Phase 22's trainer: phase 21's, fed ``(pid, tag, tokens)``; its
    report adds the feed tasks' tags."""

    def reset(self):
        self.feed_tags = []
        return super().reset()

    def step(self, fed):
        pid, tag, tokens = fed
        self.feed_tags.append(tag)
        return super().step((pid, tokens))

    def report(self):
        out = super().report()
        out["feed_tags"] = list(self.feed_tags)
        return out


def _cfg_spec(cfg) -> dict:
    """A TransformerConfig as JSON fields (dtype by name)."""
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = _dtype_name(cfg.dtype)
    return fields


def _elastic_trainer(fields, dev, params_path=None):
    """Phase 22's trainer, built where the job's actor lives: the config
    from its JSON fields, the parameters from ``params_path`` (a
    ``torch.save``d tree) or seed SEED."""
    from ray_tpu_torch.models import TransformerConfig

    fields = dict(fields)
    fields["dtype"] = getattr(torch, fields["dtype"])
    params = (torch.load(params_path, weights_only=False)
              if params_path else None)
    return _ElasticTrainer(TransformerConfig(**fields), dev, params)


def _elastic_submit(client, spec, tag):
    """Submit phase 22's job driver (``chip_smoke_job.main``) with
    ``spec``: its runtime_env sets PYTHONPATH, hides the card from the job
    driver and runs it in the repository root. Returns (job id, submit
    wall time)."""
    import shlex

    root = os.path.dirname(os.path.abspath(__file__))
    entry = (f"{shlex.quote(sys.executable)} -c "
             + shlex.quote("import sys, chip_smoke_job; "
                           "sys.exit(chip_smoke_job.main(sys.argv[1]))")
             + " " + shlex.quote(json.dumps(spec)))
    t = time.time()
    job = client.submit_job(entrypoint=entry, runtime_env={
        "env_vars": {"PYTHONPATH": root + os.pathsep
                     + os.environ.get("PYTHONPATH", ""),
                     "CUDA_VISIBLE_DEVICES": "", "ELASTIC_JOB_TAG": tag},
        "working_dir": root})
    return job, t


def _elastic_line(client, job, bound, done=False):
    """The job's ``ELASTIC_JOB`` JSON, read from its log within
    ``bound`` s (``done``: also wait for the job to end). A job that
    ends without the line, or FAILED, raises with its log."""
    from ray_tpu_torch.job_submission import JobStatus

    deadline = time.monotonic() + bound
    got = None
    while time.monotonic() < deadline:
        status = client.get_job_status(job)
        if got is None:
            for line in client.get_job_logs(job).splitlines():
                if line.startswith("ELASTIC_JOB "):
                    got = json.loads(line[len("ELASTIC_JOB "):])
        ended = status not in (JobStatus.PENDING, JobStatus.RUNNING)
        if ended and status != JobStatus.SUCCEEDED:
            raise AssertionError(f"job {job} ended {status.value}:\n"
                                 f"{client.get_job_logs(job)}")
        if got is not None and (ended or not done):
            return got, status
        time.sleep(0.1)
    raise TimeoutError(f"job {job} gave no result within {bound} s:\n"
                       f"{client.get_job_logs(job)}")


def _launch_s(events):
    """{type: [spawn to joined line s, ...]} of autoscaler scale events."""
    return {k: [e["join_latency_s"] for e in events
                if e["type"] == k and e.get("joined")]
            for k in ("card", "feed")}


def _elastic_nodes(scaler):
    """{client id: type} of the nodes the autoscaler manages now."""
    with scaler._lock:
        return {m.client_id: m.type_name for m in scaler._managed}


def _http_json(url, bound=30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=bound) as r:
        body = r.read().decode()
    return json.loads(body) if "/api/" in url else body


def phase_elastic(dev, card, cfg):
    """Phase 22 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import dashboard
    from ray_tpu_torch.autoscaler import (
        ClusterAutoscaler,
        LocalSubprocessProvider,
        NodeTypeConfig,
    )
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.util import state

    t_phase = time.perf_counter()
    L = cfg.n_layers
    checks, out, readings, part_s = {}, {}, {}, {}
    t0 = time.perf_counter()
    if dev.type == "cuda":   # both at once (built already in the script)
        _build.build_all(("flash_attention_fwd_wgmma",
                          "flash_attention_bwd_wgmma"))
    part_s["build"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    env = _cluster_env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S=str(
        NODE_CLIENT_TIMEOUT_S), RAY_TPU_FLIGHT="1")
    client = JobSubmissionClient()
    head = scaler = None
    jobs = []
    hold = "chip_smoke/elastic/hold"
    rt.shutdown()
    try:
        # The head, through the port's CLI, with its metrics scrape.
        t0 = time.perf_counter()
        head = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "start",
             "--head", "--port", "0", "--state",
             os.path.join(tmp, "head_state.log"), "--metrics-port", "0"],
            stdout=subprocess.PIPE, text=True, env=env)
        line = _read_line(head, ELASTIC_POLL_S)
        if not line.startswith("ray_tpu_torch head listening on "):
            raise AssertionError(f"the CLI's head did not start: {line!r}")
        address = line.strip().rsplit(" ", 1)[-1]
        metrics_at = _read_line(head, ELASTIC_POLL_S).strip().rsplit(
            " ", 1)[-1]
        readings["head_boot_s"] = time.perf_counter() - t0
        w = rt.init(num_cpus=0, num_gpus=0, address=address)
        scaler = ClusterAutoscaler(
            address,
            [NodeTypeConfig("card", {"CPU": 2, "GPU": 1}, 0, 1),
             NodeTypeConfig("feed", {"CPU": 2, "feed": 1}, 0, 2)],
            LocalSubprocessProvider(address, worker_mode="thread", env=env),
            idle_timeout_s=ELASTIC_IDLE_S, update_interval_s=0.5)
        dash = dashboard.start_dashboard(port=0)
        checks["a_only_the_head_at_start"] = not any(
            n.get("alive") for n in w.head_client.node_list())
        spec = {"address": address, "actor": ELASTIC_ACTOR,
                "cfg": _cfg_spec(cfg), "dev": str(dev), "tag": "job1",
                "steps": ELASTIC_STEPS, "batch": TRAIN_BATCH,
                "length": TRAIN_LEN + 1, "poll_s": ELASTIC_POLL_S}
        # (a) The job; the direct loop runs while its nodes boot.
        t0 = time.perf_counter()
        mono0 = time.monotonic()
        job1, submitted = _elastic_submit(client, spec, "job1")
        jobs.append(job1)
        # Each launched node's advertised resources and pid, read while
        # it lives (a feed node may be reaped before the job ends).
        seen, pids = {}, {}

        def watch():
            deadline = time.monotonic() + 4 * ELASTIC_POLL_S
            while client.get_job_status(job1) in (
                    JobStatus.PENDING, JobStatus.RUNNING) \
                    and time.monotonic() < deadline:
                for n in w.head_client.node_list():
                    if n.get("alive"):
                        seen[n["client_id"]] = dict(n.get("resources")
                                                    or {})
                with scaler._lock:
                    pids.update((m.client_id, m.handle["proc"].pid)
                                for m in scaler._managed)
                time.sleep(0.2)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        direct, direct_s = _node_direct(cfg, dev, ELASTIC_STEPS,
                                        _elastic_batch)
        part_s["direct"] = time.perf_counter() - t0
        got, status = _elastic_line(client, job1, 4 * ELASTIC_POLL_S,
                                    done=True)
        watcher.join(ELASTIC_POLL_S)
        if "error" in got:
            raise AssertionError(f"phase 22's job failed:\n{got['error']}")
        info = client.get_job_info(job1)
        summary = scaler.summary()
        rep = got["report"]
        kinds = {e["client_id"]: e["type"] for e in summary["scale_events"]
                 if e.get("joined")}
        checks["a_job_succeeded"] = status == JobStatus.SUCCEEDED
        checks["a_losses_bit_equal_direct"] = got["losses"] == direct
        checks["a_launches_in_launched_card_node"] = rep.get(
            "counts") == _want_counts("wgmma", ELASTIC_STEPS * L,
                                      ELASTIC_STEPS * L)
        checks["a_plain_routes_0"] = rep.get("plain_routes") == 0
        card_ids = [c for c, k in kinds.items() if k == "card"]
        feed_ids = [c for c, k in kinds.items() if k == "feed"]
        checks["a_trainer_in_card_daemon"] = (
            rep["device"] == str(dev)
            and rep["pid"] in {pids.get(c) for c in card_ids}
            and rep["pid"] not in (os.getpid(), got["pid"]))
        feed_pids = {pids.get(c) for c in feed_ids}
        checks["a_feed_tags_seen"] = rep["feed_tags"] == [
            f"job1-{i}" for i in range(ELASTIC_STEPS)]
        checks["a_feed_tasks_in_feed_daemons"] = bool(rep["feed_pids"]) \
            and set(rep["feed_pids"]) <= feed_pids \
            and not {os.getpid(), got["pid"]} & set(rep["feed_pids"])
        checks["a_card_node_advertises_gpu_1"] = bool(card_ids) and all(
            seen.get(c, {}).get("GPU") == 1.0 for c in card_ids)
        checks["a_feed_nodes_advertise_no_gpu"] = bool(feed_ids) and all(
            c in seen and not seen[c].get("GPU") for c in feed_ids)
        checks["a_job_driver_saw_its_env"] = (
            got["job_tag"] == "job1" and got["cuda_visible"] == ""
            and os.path.realpath(got["cwd"]) == os.path.realpath(
                os.path.dirname(os.path.abspath(__file__))))
        checks["a_one_card_launch"] = summary["launched"].count("card") == 1
        checks["a_feed_launched"] = summary["launched"].count("feed") >= 1
        checks["a_no_launch_failure"] = (summary["launch_failures"] == 0
                                         and summary["launch_errors"] == 0)
        checks["a_join_latency_recorded"] = all(
            e.get("join_latency_s", 0) > 0
            for e in summary["scale_events"])
        elastic = state.autoscaler_summary()
        api = _http_json(dash.url + "/api/elastic")
        snap = _http_json(dash.url + "/api/snapshot")
        checks["a_state_and_dashboard_agree"] = (
            elastic["autoscalers"][0]["launched"] == summary["launched"]
            == api["autoscalers"][0]["launched"]
            == snap["elastic"]["autoscalers"][0]["launched"])
        readings["job1_submit_to_first_step_s"] = (
            got["first_step_wall"] - submitted)
        # Where job 1's wait went (host clock, from its submission).
        readings["job1_timeline_s"] = {
            "driver_attached": got["attached_wall"] - submitted,
            "launches": [[e["type"], e["launch_started"] - mono0,
                          e["joined"] - mono0]
                         for e in summary["scale_events"]
                         if e.get("joined")],
            "trainer_placed": got["placed_wall"] - submitted,
            "trainer_init": rep["init_s"],
            "trainer_init_split": rep["init_split_s"],
            "first_step": rep["step_s"][0],
            "first_step_done": got["first_step_wall"] - submitted}
        readings["launch_s"] = _launch_s(summary["scale_events"])
        n_events = len(summary["scale_events"])
        readings["step_ms_p50_job"] = _p50(rep["step_s"][1:]) * 1e3
        readings["step_ms_p50_direct"] = _p50(direct_s[1:]) * 1e3
        out["a"] = {"losses": got["losses"], "direct_losses": direct,
                    "launches_per_step": {
                        k: v / ELASTIC_STEPS
                        for k, v in rep.get("counts", {}).items() if v},
                    "plain_routes": rep.get("plain_routes"),
                    "launched": summary["launched"],
                    "advertised": {kinds.get(c, c): r
                                   for c, r in seen.items()}}
        part_s["a"] = time.perf_counter() - t0
        # (b) Scale to zero, then up again for a second job, whose
        # driver boots and attaches meanwhile but makes no demand before
        # the go key.
        t0 = time.perf_counter()
        go = "chip_smoke/elastic/go"
        spec2 = dict(spec, tag="job2", steps=ELASTIC_STEPS_2, hold=hold,
                     go=go)
        job2, submitted2 = _elastic_submit(client, spec2, "job2")
        jobs.append(job2)
        deadline = time.monotonic() + ELASTIC_IDLE_S + ELASTIC_REAP_S
        while len(scaler.terminated) < len(scaler.launched) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        reaped = time.time()
        summary = scaler.summary()
        alive = [n for n in w.head_client.node_list() if n.get("alive")]
        checks["b_reaped_to_zero"] = (
            scaler.num_nodes_of_type("card") == 0
            and scaler.num_nodes_of_type("feed") == 0)
        checks["b_every_reap_drained"] = (
            summary["drained_nodes"] == len(summary["launched"])
            == len(summary["terminated"]))
        checks["b_no_untransferred_object"] = summary[
            "drain_untransferred_objects"] == 0
        deadline = time.monotonic() + ELASTIC_REAP_S
        while alive and time.monotonic() < deadline:
            time.sleep(0.1)
            alive = [n for n in w.head_client.node_list() if n.get("alive")]
        checks["b_membership_head_alone"] = not alive
        readings["idle_to_reaped_s"] = reaped - info.end_time
        out["b_scale_events_s"] = [
            [e["type"], e["launch_started"] - mono0,
             e["joined"] - mono0 if e.get("joined") else None]
            for e in summary["scale_events"]]
        went = time.time()
        w.kv_put(go.encode(), b"1")
        got2, _ = _elastic_line(client, job2, 4 * ELASTIC_POLL_S)
        if "error" in got2:
            raise AssertionError(f"phase 22's second job failed:\n"
                                 f"{got2['error']}")
        summary = scaler.summary()
        checks["b_losses_bit_equal_direct"] = got2["losses"] == direct[
            :ELASTIC_STEPS_2]
        checks["b_relaunched_both_types"] = (
            summary["launched"].count("card") == 2
            and summary["launched"].count("feed") >= 2)
        checks["b_launches_in_card_node"] = got2["report"].get(
            "counts") == _want_counts("wgmma", ELASTIC_STEPS_2 * L,
                                      ELASTIC_STEPS_2 * L)
        readings["job2_submit_to_first_step_s"] = (
            got2["first_step_wall"] - submitted2)
        readings["job2_go_to_first_step_s"] = got2["first_step_wall"] - went
        readings["job2_launch_s"] = _launch_s(
            summary["scale_events"][n_events:])
        readings["job2_trainer_init_s"] = got2["report"]["init_s"]
        readings["job2_trainer_init_split_s"] = got2["report"][
            "init_split_s"]
        out["b"] = {"losses": got2["losses"],
                    "launched": summary["launched"],
                    "terminated": summary["terminated"]}
        part_s["b"] = time.perf_counter() - t0
        # (c) The operator's tools, while the second job's nodes live.
        t0 = time.perf_counter()
        # The two CLI commands run at once, the scrapes meanwhile.
        live = _elastic_nodes(scaler)
        command = f"{sys.executable} -c \"print('elastic-cli-job-ok')\""
        cli = {name: subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for name, argv in (
                ("debug", ["debug", "--address", address, "--output",
                           os.path.join(tmp, "debug")]),
                ("job", ["job", "submit", command]))}
        metrics = _http_json(dash.url + "/metrics")
        scraped = _http_json(f"http://{metrics_at}/metrics")
        checks["c_dashboard_metrics_every_live_daemon"] = bool(live) and all(
            f'node="{c}"' in metrics for c in live)
        checks["c_head_scrape_every_live_daemon"] = bool(live) and all(
            f'node="{c}"' in scraped for c in live)
        done = {}
        for name, proc in cli.items():
            try:
                stdout, _ = proc.communicate(timeout=ELASTIC_POLL_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, _ = proc.communicate()
            done[name] = (proc.returncode, stdout)
        try:
            sources = set(json.loads(done["debug"][1])["sources"])
        except ValueError:
            sources = set()
        want = {"head"} | {f"node-{c}" for c in live}
        checks["c_debug_bundles_every_live_daemon"] = (
            done["debug"][0] == 0 and bool(live) and want <= sources)
        checks["c_cli_job_submit"] = (done["job"][0] == 0
                                      and "elastic-cli-job-ok"
                                      in done["job"][1])
        w.kv_put(hold.encode(), b"1")
        _, status2 = _elastic_line(client, job2, ELASTIC_POLL_S, done=True)
        checks["c_second_job_succeeded"] = status2 == JobStatus.SUCCEEDED
        out["c"] = {"debug_sources": sorted(sources),
                    "live": sorted(live.values()),
                    "debug_rc": done["debug"][0],
                    "cli_job_rc": done["job"][0]}
        part_s["c"] = time.perf_counter() - t0
    finally:
        dashboard.stop_dashboard()
        for job in jobs:
            client.stop_job(job)
        if scaler is not None:
            scaler.shutdown()
        rt.shutdown()
        if head is not None and head.poll() is None:
            head.kill()
            head.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "phase": "elastic", "config": {
            "d_model": cfg.d_model, "n_layers": L,
            "dtype": _dtype_name(cfg.dtype),
            "train_batch": [TRAIN_BATCH, TRAIN_LEN],
            "steps": ELASTIC_STEPS, "steps_second_job": ELASTIC_STEPS_2,
            "idle_timeout_s": ELASTIC_IDLE_S},
        "checks": checks, **out, "readings": readings, "part_s": part_s,
        "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 22 (elastic) failed {failed}")
    return result


def _dist_tokens(cfg, steps):
    """Phase 23's global batches: [steps, DIST_BATCH, DIST_LEN + 1] on the
    host, from a seed."""
    rng = np.random.default_rng(SEED + 23)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (steps, DIST_BATCH, DIST_LEN + 1)))


def _dist_leaves(shards):
    """Every shard's f32 leaves on the host, by "<shard>/<path>" (the
    names torch_distributed_worker.py writes)."""
    import torch_distributed_worker as worker

    return {f"{j}/{path}": leaf.detach().cpu().numpy()
            for j, tree in shards for path, leaf in worker._flat(tree)}


def _dist_steps(step, tokens, rows, dev, steps):
    """``steps`` steps on ``rows`` of each global batch: (losses, the
    seconds of each step, host clock, the card synchronised)."""
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        batch = tokens[i, rows].to(dev)
        losses.append(step(batch[:, :-1], batch[:, 1:]).item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs


def _dist_jobs(cfg, mesh, steps):
    """The step jobs of phase 23's workers (torch_distributed_worker.py):
    ``steps`` steps of the default AdamW with the launches counted, then
    DIST_SGD_STEPS of SGD, each on make_mesh(**mesh) from the seed's
    weights."""
    base = {"kind": "step", "cfg": _cfg_spec(cfg), "mesh": dict(mesh),
            "init_seed": SEED, "microbatches": DIST_MICROBATCHES}
    return [dict(base, name="adamw", optimizer="default", steps=steps,
                 counts=True),
            dict(base, name="sgd", optimizer="sgd", lr=DIST_SGD_LR,
                 steps=DIST_SGD_STEPS, counts=True)]


def _dist_hop_shape(cfg):
    """One microbatch's activation between two stages: [rows, len, d]."""
    return [DIST_BATCH // DIST_MICROBATCHES, DIST_LEN, cfg.d_model]


def _dist_run(cfg, ids, backend, steps, tmp, allreduce_elements=0,
              mesh=None, hop=False, allreduce_dtype="float32"):
    """Phase 23's worker processes (torch_distributed_worker.py), one for
    each entry of ``ids`` (its cards), over ``backend``: _dist_jobs on
    make_mesh(**mesh) (default: dp over the processes), then, given
    ``allreduce_elements``, DIST_ALLREDUCE_ITERS timed all-reduces of that
    many elements of ``allreduce_dtype``, and with ``hop`` DIST_HOP_ITERS
    timed hops of one bf16 activation (_dist_hop_shape) from process 0 to
    process 1. Returns (each process's report, each one's leaves by job);
    every wait within DIST_POLL_S, every process killed on the way
    out."""
    import torch_distributed_worker as worker

    jobs = _dist_jobs(cfg, mesh or {"dp": len(ids)}, steps)
    if allreduce_elements:
        jobs.append({"kind": "allreduce", "elements": allreduce_elements,
                     "iters": DIST_ALLREDUCE_ITERS,
                     "dtype": allreduce_dtype})
    if hop:
        jobs.append({"kind": "hop", "shape": _dist_hop_shape(cfg),
                     "dtype": "bfloat16", "iters": DIST_HOP_ITERS})
    tokens = _dist_tokens(cfg, steps).numpy()
    outs = worker.launch(jobs, tmp, processes=len(ids), backend=backend,
                         local_device_ids=ids,
                         arrays={"tokens": tokens[:, :, :-1],
                                 "targets": tokens[:, :, 1:]},
                         timeout_s=DIST_POLL_S)
    reports, leaves = [], []
    for out in outs:
        r = {"rank": int(out["process_index"]),
             "devices": out["devices"].tolist(), "backend": backend,
             "jax_imported": bool(out["jax_imported"]),
             "ray_tpu_imported": bool(out["ray_tpu_imported"])}
        mine = {}
        for job in ("adamw", "sgd"):
            r[job] = {"local_indices": out[f"{job}/local_indices"].tolist(),
                      "losses": out[f"{job}/losses"].tolist(),
                      "step_s": out[f"{job}/seconds"].tolist(),
                      "build_s": float(out[f"{job}/build_s"]),
                      "counts": json.loads(str(out[f"{job}/counts"]))}
            mine[job] = {k.split("/", 1)[1]: v for k, v in out.items()
                         if k.startswith(job + "/")
                         and k.split("/")[1].isdigit()}
        if allreduce_elements:
            r["allreduce"] = {"bytes": getattr(
                                  torch, allreduce_dtype).itemsize
                              * allreduce_elements,
                              "dtype": allreduce_dtype,
                              "elements": allreduce_elements,
                              "s": out["allreduce/seconds"].tolist(),
                              "exact": bool(out["allreduce/exact"])}
        if hop:
            r["hop"] = {"bytes": int(out["hop/bytes"]),
                        "s": out["hop/seconds"].tolist(),
                        "arrived": bool(out["hop/arrived"])}
        reports.append(r)
        leaves.append(mine)
    return reports, leaves


def _dist_one_process(cfg, devices, steps, sgd=False, mesh=None):
    """The oracle: the flagship's step (the default AdamW, or SGD) on
    make_mesh(**mesh) (default: dp over ``devices``) in this process over
    the whole of each batch: (losses, step seconds, shards)."""
    from ray_tpu_torch.models import init_params, make_spmd_train_step
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(**(mesh or {"dp": len(devices)})),
                     devices=devices)
    step, _, shards = make_spmd_train_step(
        cfg, mesh, init_params(cfg, SEED, device=devices[0]),
        optimizer=((lambda ls: torch.optim.SGD(ls, lr=DIST_SGD_LR))
                   if sgd else None),
        n_microbatches=DIST_MICROBATCHES)
    losses, secs = _dist_steps(step, _dist_tokens(cfg, steps),
                               slice(None), devices[0], steps)
    return losses, secs, shards


def _dist_oracle(cfg, devices, steps, mesh=None):
    """Both jobs' oracles on ``devices`` (make_mesh(**mesh), default dp
    over them): per job, (losses, step seconds, every shard's leaves)."""
    out = {}
    for job, n, sgd in (("adamw", steps, False),
                        ("sgd", DIST_SGD_STEPS, True)):
        losses, secs, shards = _dist_one_process(cfg, devices, n, sgd, mesh)
        out[job] = (losses, secs, _dist_leaves(enumerate(shards)))
        del shards
        torch.cuda.empty_cache()
    return out


def _dist_check(tag, cfg, reports, leaves, oracle, loss_tol, leaf_tol,
                fails, mesh=None, each=1, adamw_fraction=None):
    """Holds each process of ``reports`` against the one-process
    ``oracle`` job by job: every loss to ``loss_tol`` (relative) and
    every leaf of its shards to ``leaf_tol`` (absolute), its launches
    (forward, dQ and dK/dV a step on the kernels of ``cfg``'s type: on
    the tensor cores for bf16, the tiled f32 kernels for f32; n_layers
    times a shard, or with ``pp`` stages its stage's n_layers / pp
    layers once a microbatch, as its shards of the one-process mesh,
    and none with ``sp``, whose ring attention takes plain blocks), its
    ``each`` shards (from its rank times ``each``) and its imports.
    Given ``adamw_fraction``, the AdamW job's leaves are held to the share
    of their elements beyond ``leaf_tol`` instead. Returns per job the
    largest errors and how many leaf elements differ by more than 1e-7 ..
    1e-4."""
    mesh = mesh or {}
    pp = mesh.get("pp", 1)
    calls = (cfg.n_layers if pp == 1
             else cfg.n_layers // pp * DIST_MICROBATCHES) * each
    if mesh.get("sp", 1) > 1:
        calls = 0
    per_step = _want_counts(
        "wgmma" if cfg.dtype == torch.bfloat16 else "tiled_f32", calls,
        calls)
    errs = {}
    for job, (want, _, ref) in oracle.items():
        leaf_err, loss_err, beyond = 0.0, 0.0, [0, 0, 0, 0]
        over, total = 0, 0
        for r, mine in zip(reports, leaves):
            got, rj = mine[job], r[job]
            if sorted(got) != sorted(k for k in ref if int(k.split(
                    "/")[0]) in rj["local_indices"]):
                fails.append(f"{tag} rank {r['rank']} {job}: "
                             f"{len(got)} leaves")
            for k, v in got.items():
                d = np.abs(v - ref[k])
                leaf_err = max(leaf_err, float(d.max()))
                beyond = [b + int((d > t).sum()) for b, t in
                          zip(beyond, (1e-7, 1e-6, 1e-5, 1e-4))]
                over += int((d > leaf_tol).sum())
                total += d.size
            err = max(abs(g - w) / abs(w)
                      for g, w in zip(rj["losses"], want))
            loss_err = max(loss_err, err)
            steps = len(rj["losses"])
            counts = {k: v / steps for k, v in rj["counts"].items()}
            rj.update(loss_err=err, launches_per_step=counts)
            mine_idx = list(range(r["rank"] * each, (r["rank"] + 1) * each))
            if (not err <= loss_tol or counts != per_step
                    or r["jax_imported"] or r["ray_tpu_imported"]
                    or rj["local_indices"] != mine_idx
                    or len(rj["losses"]) != len(want)):
                fails.append(f"{tag} rank {r['rank']} {job}: loss err "
                             f"{err}, launches {counts} != {per_step}, "
                             f"shards {rj['local_indices']}, jax "
                             f"{r['jax_imported']}")
        errs[job] = {"loss_err": loss_err, "update_err": leaf_err,
                     "elements_beyond_1e-7_1e-6_1e-5_1e-4": beyond,
                     "elements": total, "loss_tol": loss_tol,
                     "update_tol": leaf_tol}
        held = leaf_err <= leaf_tol
        if job == "adamw" and adamw_fraction is not None:
            errs[job]["fraction_beyond_update_tol"] = over / total
            errs[job]["fraction_tol"] = adamw_fraction
            held = over <= adamw_fraction * total
        if not held or not all(np.isfinite(want)):
            fails.append(f"{tag} {job}: leaf err {leaf_err} > {leaf_tol} "
                         f"at {over} of {total} elements, losses {want}")
    return errs


def phase_distributed(dev, card, cfg):
    """Phase 23 (see the module docstring): the multi-process device
    plane."""
    from ray_tpu_torch import collective as tops
    from ray_tpu_torch.parallel import (
        HybridMeshConfig,
        distributed,
        make_hybrid_mesh,
    )

    t_phase = time.perf_counter()
    fails, res = [], {"card": card}
    # (a) One process: initialize() is a no-op; a sum over each tier of
    # the hybrid mesh over 4 virtual shards of the card.
    distributed.initialize()
    a = {"is_initialized": distributed.is_initialized(),
         "process_count": distributed.process_count(),
         "process_index": distributed.process_index(),
         "batch_slice": list(distributed.host_local_batch_slice(
             DIST_BATCH))}
    mesh = make_hybrid_mesh(HybridMeshConfig(dcn={"dp": 2},
                                             ici={"tp": 2}),
                            devices=[dev] * 4)
    x = torch.arange(4 * 8, dtype=torch.float32, device=dev).reshape(4, 8)
    got = tops.allreduce(tops.allreduce(list(x.split(1)), mesh, "tp"),
                         mesh, "dp")
    a.update(axis_names=list(mesh.axis_names),
             spans_processes=mesh.spans_processes,
             tier_sums_exact=all(bool((g == x.sum(0, keepdim=True)).all())
                                 for g in got))
    distributed.shutdown()
    a["after_shutdown"] = distributed.is_initialized()
    res["a"] = a
    if a != {"is_initialized": True, "process_count": 1, "process_index": 0,
             "batch_slice": [0, DIST_BATCH], "axis_names": ["dp", "tp"],
             "spans_processes": False, "tier_sums_exact": True,
             "after_shutdown": False}:
        fails.append(f"(a) {a}")
    # (b) Two processes on this one card over gloo, dp 2 across them,
    # against the one-process dp-2 mesh over 2 virtual shards of the card.
    emit({"distributed_b_backend": "gloo",
          "why": "NCCL refuses two ranks on one device, so the two "
                 "processes on the one card meet over gloo; NCCL runs in "
                 "(c), a process per card"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        oracle = _dist_oracle(cfg, [dev, dev], DIST_STEPS)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reports, leaves = _dist_run(cfg, [[0], [0]], "gloo", DIST_STEPS,
                                    tmp)
        run_s = time.perf_counter() - t0
        b = {"one_process_s": one_s, "two_processes_s": run_s,
             "losses_one_process": {j: o[0] for j, o in oracle.items()},
             "reports": reports,
             "errors": _dist_check("(b)", cfg, reports, leaves, oracle,
                                   DIST_LOSS_TOL, DIST_UPDATE_TOL, fails),
             "step_p50_ms": {
                 "two_processes_gloo": _p50(
                     [s for r in reports
                      for s in r["adamw"]["step_s"][1:]]) * 1e3,
                 "one_process_two_virtual_shards": _p50(
                     oracle["adamw"][1][1:]) * 1e3}}
        del oracle, leaves
        res["b"] = b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # (c) NCCL, a process per card.
    n = torch.cuda.device_count()
    if n < 2:
        emit({"distributed_c": "skipped", "why": f"{n} CUDA card visible; "
              f"NCCL between processes needs a card each, so (c) runs "
              f"where at least two cards are"})
        res["c"] = None
    else:
        res["c"] = _dist_nccl(cfg, [torch.device("cuda", i)
                                    for i in range(n)], fails)
    # (d) pp across two processes on this one card over gloo, a stage in
    # each, against the one-process pp-2 mesh over 2 virtual shards.
    emit({"distributed_d_backend": "gloo",
          "why": "NCCL refuses two ranks on one device, so the two "
                 "stages' processes on the one card meet over gloo",
          "hop": "gloo has no point-to-point for CUDA tensors, so a hop "
                 "across the processes goes through host memory: the "
                 "activation copied to the host, sent and received "
                 "there, and copied onto the receiver's card"})
    res["d"] = _dist_layout("(d)", cfg, [dev, dev], [[0], [0]], "gloo",
                            {"pp": 2}, DIST_STEPS, fails, hop=True)
    # (e) NCCL, a process per card, pp across them.
    if n < 4:
        emit({"distributed_e": "skipped", "why": f"{n} CUDA card(s) "
              f"visible; (e) runs make_mesh(dp=2, pp=2) over four "
              f"processes of a card each, so it runs where at least four "
              f"cards are"})
        res["e"] = None
    else:
        cards = [torch.device("cuda", i) for i in range(4)]
        res["e"] = {
            "dp2-pp2": _dist_layout("(e) dp2-pp2", cfg, cards,
                                    [[i] for i in range(4)], "nccl",
                                    {"dp": 2, "pp": 2}, DIST_NCCL_STEPS,
                                    fails, hop=True),
            "pp2": _dist_layout("(e) pp2", cfg, cards[:2], [[0], [1]],
                                "nccl", {"pp": 2}, DIST_NCCL_STEPS, fails,
                                hop=True)}
    # (f) tp across processes: two processes on this one card over gloo,
    # make_mesh(tp=2), against the one-process tp-2 mesh over 2 virtual
    # shards of the card.
    emit({"distributed_f_backend": "gloo",
          "why": "NCCL refuses two ranks on one device, so the two tp "
                 "shards' processes on the one card meet over gloo",
          "allreduce": "gloo all-reduces a CUDA tensor through host "
                       "memory: each row-parallel sum is copied to the "
                       "host, summed there and copied back"})
    res["f"] = {"tp2": _dist_layout(
        "(f) tp2", cfg, [dev, dev], [[0], [0]], "gloo", {"tp": 2},
        DIST_STEPS, fails, allreduce_shape=_dist_hop_shape(cfg))}
    if n < 4:
        emit({"distributed_f_four_cards": "skipped", "why": f"{n} CUDA "
              f"card(s) visible; (f) runs make_mesh(tp=4) over four "
              f"processes of a card each and make_mesh(tp=2, sp=2) over "
              f"two processes of two cards each where at least four "
              f"cards are"})
    else:
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        cards = [torch.device("cuda", i) for i in range(4)]
        res["f"].update({
            "tp4x1": _dist_layout(
                "(f) tp4x1", cfg32, cards, [[i] for i in range(4)], "nccl",
                {"tp": 4}, DIST_NCCL_STEPS, fails,
                allreduce_shape=_dist_hop_shape(cfg),
                adamw_fraction=DIST_REORDER_FRACTION),
            "tp2x2": _dist_layout(
                "(f) tp2x2", cfg32, cards, [[0, 1], [2, 3]], "nccl",
                {"tp": 2, "sp": 2}, DIST_NCCL_STEPS, fails,
                allreduce_shape=_dist_hop_shape(cfg),
                adamw_fraction=DIST_REORDER_FRACTION)})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "distributed", "results": res, "seconds": seconds,
          "card": card})
    if fails:
        raise AssertionError(f"phase 23: {fails}")
    b = res["b"]
    emit({"distributed_step_smoke_reading": "b",
          "tokens_per_step": DIST_BATCH * DIST_LEN,
          "step_p50_ms_host_clock": b["step_p50_ms"], "card": card})
    if res["c"] is not None:
        emit({"distributed_step_smoke_reading": "c",
              **{k: res["c"][k] for k in (
                  "cards", "step_p50_ms", "allreduce", "errors")},
              "tokens_per_step": DIST_BATCH * DIST_LEN, "card": card})
    for tag, run in [("d", res["d"])] + [
            (f"e {k}", v) for k, v in (res["e"] or {}).items()] + [
            (f"f {k}", v) for k, v in res["f"].items()]:
        emit({"distributed_step_smoke_reading": tag,
              **{k: run.get(k) for k in (
                  "mesh", "backend", "cards_each", "dtype", "step_p50_ms",
                  "hop", "allreduce", "errors")},
              "tokens_per_step": DIST_BATCH * DIST_LEN, "card": card})
    emit({"distributed_phase_s": seconds, "card": card})
    return res


def _dist_layout(tag, cfg, devices, ids, backend, mesh, steps, fails,
                 hop=False, allreduce_shape=None, adamw_fraction=None):
    """Phase 23 (d), (e) and (f): the flagship's step on make_mesh(**mesh),
    some axis of which crosses the processes of ``ids`` (their cards)
    over ``backend``, against one process over ``devices`` on the same
    mesh: the losses, every leaf, each process's launches (its shards of
    the one-process mesh) and imports (_dist_check); the step p50 of
    both; with ``hop`` the seconds of one hop of a bf16 activation from
    process 0 to process 1, and given ``allreduce_shape`` the seconds of
    one all-reduce of a bf16 activation of that shape across the
    processes (each process's clock). ``adamw_fraction``: _dist_check's."""
    t0 = time.perf_counter()
    oracle = _dist_oracle(cfg, devices, steps, mesh)
    one_s = time.perf_counter() - t0
    elements = int(np.prod(allreduce_shape)) if allreduce_shape else 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_layout_")
    try:
        t0 = time.perf_counter()
        reports, leaves = _dist_run(cfg, ids, backend, steps, tmp,
                                    mesh=mesh, hop=hop,
                                    allreduce_elements=elements,
                                    allreduce_dtype="bfloat16")
        run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"mesh": mesh, "backend": backend, "processes": len(ids),
           "cards_each": len(ids[0]), "dtype": str(cfg.dtype),
           "one_process_s": one_s, "processes_s": run_s,
           "losses_one_process": {j: o[0] for j, o in oracle.items()},
           "reports": reports,
           "errors": _dist_check(tag, cfg, reports, leaves, oracle,
                                 DIST_LOSS_TOL, DIST_UPDATE_TOL, fails,
                                 mesh=mesh, each=len(ids[0]),
                                 adamw_fraction=adamw_fraction),
           "step_p50_ms": {
               "processes": _p50([s for r in reports
                                  for s in r["adamw"]["step_s"][1:]]) * 1e3,
               "one_process": _p50(oracle["adamw"][1][1:]) * 1e3}}
    if hop:
        if not all(r["hop"]["arrived"] for r in reports):
            fails.append(f"{tag} the timed hop's value did not arrive "
                         f"intact")
        out["hop"] = {
            "shape": _dist_hop_shape(cfg), "dtype": "bfloat16",
            "bytes": reports[0]["hop"]["bytes"],
            "route": "host memory" if backend == "gloo" else "NCCL",
            "p50_ms_sender": _p50(reports[0]["hop"]["s"]) * 1e3,
            "p50_ms_receiver": _p50(reports[1]["hop"]["s"]) * 1e3}
    if allreduce_shape:
        if not all(r["allreduce"]["exact"] for r in reports):
            fails.append(f"{tag} the timed all-reduce is not exact")
        out["allreduce"] = {
            "shape": list(allreduce_shape), "dtype": "bfloat16",
            "bytes": reports[0]["allreduce"]["bytes"],
            "route": "host memory" if backend == "gloo" else "NCCL",
            "p50_ms": _p50([t for r in reports
                            for t in r["allreduce"]["s"]]) * 1e3}
    return out


def _dist_nccl(cfg, cards, fails, backend="nccl"):
    """Phase 23 (c): the flagship's step p50 on one card, in one process
    over the n ``cards`` (peer copies), and in n processes over NCCL (one
    card each), whose losses and leaves are held against the one process
    over the n cards; and the all-reduce of its f32 gradient alone."""
    n = len(cards)
    _, one_s, _ = _dist_one_process(cfg, cards[:1], DIST_NCCL_STEPS)
    torch.cuda.empty_cache()
    oracle = _dist_oracle(cfg, cards, DIST_NCCL_STEPS)
    elements = sum(v.size for k, v in oracle["adamw"][2].items()
                   if k.startswith("0/"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        reports, leaves = _dist_run(cfg, [[i] for i in range(n)], backend,
                                    DIST_NCCL_STEPS, tmp,
                                    allreduce_elements=elements)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ar = reports[0]["allreduce"]
    ar_s = _p50([s for r in reports for s in r["allreduce"]["s"]])
    c = {"cards": n,
         "losses_one_process_n_cards": {j: o[0] for j, o in oracle.items()},
         "reports": reports,
         "errors": _dist_check("(c)", cfg, reports, leaves, oracle,
                               DIST_LOSS_TOL, DIST_UPDATE_TOL, fails),
         "step_p50_ms": {
             "one_card": _p50(one_s[1:]) * 1e3,
             "one_process_n_cards_peer_copies": _p50(
                 oracle["adamw"][1][1:]) * 1e3,
             "n_processes_nccl": _p50([s for r in reports
                                       for s in r["adamw"]["step_s"][1:]])
             * 1e3},
         "allreduce": {"bytes": ar["bytes"], "p50_ms": ar_s * 1e3,
                       "bus_GBps": ar["bytes"] * 2 * (n - 1) / n / ar_s
                       / 1e9}}
    if not all(r["allreduce"]["exact"] for r in reports):
        fails.append("(c) the timed all-reduce is not exact")
    return c


def _deciles_ms(xs):
    """p10, p50 and p90 of ``xs`` seconds, in ms (nearest rank)."""
    xs = sorted(xs)
    return [xs[min(int(q * len(xs)), len(xs) - 1)] * 1e3
            for q in (0.1, 0.5, 0.9)] if xs else None


def _alive(pid: int) -> bool:
    """The process runs (not gone, not a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except (OSError, IndexError):
        return False


# -------------------------------------------------------- phase 24: formats
def _pandas_rows(df):
    """Phase 24 (a)'s pandas stage: the rows pass through unchanged."""
    return df


def _formats_parquet_trainer(data, cfg, dev, tokens, root):
    """Phase 24 (a): the token table written with write_parquet into
    FORMATS_PARTS hive partitions (a list column of 1-D rows: pa.array
    takes 1-D columns), read back with read_parquet(columns=...) through a
    pandas map_batches stage and stacked, and the flagship trained from it
    through DataParallelTrainer against make_train_step called directly on
    the rows the worker took."""
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig

    fa, L, steps = _flash_module(), cfg.n_layers, DATA_TRAIN_STEPS
    checks = {}
    pq_root = os.path.join(root, "pq")
    rows = np.empty(len(tokens), dtype=object)
    for i, r in enumerate(tokens):
        rows[i] = r
    cuts = np.linspace(0, len(tokens), FORMATS_PARTS + 1).astype(int)
    t0 = time.perf_counter()
    for part in range(FORMATS_PARTS):
        lo, hi = cuts[part], cuts[part + 1]
        data.from_columns({"tokens": rows[lo:hi]}, parallelism=2
                          ).write_parquet(os.path.join(pq_root,
                                                       f"part={part}"))
    write_s = time.perf_counter() - t0
    nbytes = _dir_bytes(pq_root)
    t0 = time.perf_counter()
    raw = data.read_parquet(pq_root, columns=["tokens", "part"]).to_pandas()
    read_s = time.perf_counter() - t0
    back = np.stack(list(raw["tokens"])).astype(np.int64)
    checks["a_parquet_bit_equal"] = (back.shape == tokens.shape
                                     and np.array_equal(back, tokens))
    checks["a_hive_partition_column"] = list(raw["part"]) == [
        p for p in range(FORMATS_PARTS)
        for _ in range(cuts[p + 1] - cuts[p])]
    ds = (data.read_parquet(pq_root, columns=["tokens", "part"])
          .map_batches(_pandas_rows, batch_format="pandas")
          .map_batches(_stack_tokens, batch_size=None))
    _zero_counts()
    plain = fa.plain_routes
    res = DataParallelTrainer(
        _data_loop, train_loop_config={"cfg": cfg, "device": str(dev),
                                       "steps": steps},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": ds}).fit()
    counts, plain_t = _counts(), fa.plain_routes - plain
    hist = res.metrics_history
    taken = np.concatenate([m["rows"] for m in hist])
    direct, direct_s, direct_counts, direct_plain = _trainer_direct(
        cfg, dev, taken, steps)
    checks["a_worker_rows_in_table_order"] = np.array_equal(
        taken, tokens[:len(taken)])
    checks["a_losses_bit_equal"] = [m["loss"] for m in hist] == direct
    want = _want_counts("wgmma", steps * L, steps * L)
    checks["a_launches_per_step"] = counts == want and direct_counts == want
    checks["a_plain_routes_0"] = plain_t == 0 and direct_plain == 0
    return checks, {
        "rows": int(tokens.shape[0]), "row_len": int(tokens.shape[1]),
        "partitions": sorted(os.listdir(pq_root)),
        "files": sum(len(os.listdir(os.path.join(pq_root, d)))
                     for d in os.listdir(pq_root)),
        "parquet_bytes": nbytes, "write_parquet_s": write_s,
        "read_parquet_s": read_s, "write_MBps": nbytes / write_s / 1e6,
        "read_MBps": nbytes / read_s / 1e6, "steps": len(hist),
        "losses": [m["loss"] for m in hist], "direct_losses": direct,
        "launches_per_step": {k: v / steps for k, v in counts.items() if v},
        "plain_routes": plain_t,
        "step_ms_p50": _p50([m["step_s"] for m in hist[1:]]) * 1e3,
        "direct_step_ms_p50": _p50(direct_s[1:]) * 1e3}


def _formats_round_trips(data, root):
    """Phase 24 (b): parquet, CSV and JSON written and read back on
    memory:// and on the fsspec scheme local://, each equal to its
    source; PNGs written with PIL read back equal by read_images."""
    from PIL import Image

    checks, out = {}, {}
    a = np.arange(FORMATS_ROWS, dtype=np.int64)
    src = {"a": a, "b": a / 2.0, "s": np.asarray([f"row{i}" for i in a])}
    ds = data.from_columns(src, parallelism=4)
    for scheme, base in (("memory", "memory://smoke24"),
                         ("local", f"local://{root}/fsspec")):
        kinds = {}
        for fmt in ("parquet", "csv", "json"):
            uri = f"{base}/{fmt}"
            t0 = time.perf_counter()
            getattr(ds, f"write_{fmt}")(uri)
            t1 = time.perf_counter()
            df = getattr(data, f"read_{fmt}")(uri).to_pandas()
            t2 = time.perf_counter()
            df = df.sort_values("a").reset_index(drop=True)
            checks[f"b_{scheme}_{fmt}_equal"] = (
                list(df.columns) == ["a", "b", "s"]
                and np.array_equal(df["a"].to_numpy(), a)
                and np.array_equal(df["b"].to_numpy(), src["b"])
                and df["s"].tolist() == src["s"].tolist())
            fs, p = data.resolve_filesystem(uri)
            kinds[fmt] = {"write_s": t1 - t0, "read_s": t2 - t1,
                          "files": len(fs.listdir(p)),
                          "filesystem": type(fs).__name__}
        out[scheme] = kinds
    checks["b_local_is_fsspec"] = all(
        k["filesystem"] == "_FsspecFilesystem" for k in out["local"].values())
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(SEED + 24)
    pixels = {}
    for i in range(FORMATS_IMAGES):
        arr = rng.integers(0, 256, FORMATS_IMAGE_SHAPE, dtype=np.uint8)
        name = f"img{i}.png"
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        pixels[name] = arr
    got = {os.path.basename(r["path"]): r["image"]
           for r in data.read_images(img_dir).iter_rows()}
    checks["b_images_equal"] = (sorted(got) == sorted(pixels) and all(
        np.array_equal(got[k], v) for k, v in pixels.items()))
    out["images"] = {"count": len(got), "shape": list(FORMATS_IMAGE_SHAPE)}
    return checks, out


def _bert_init():
    """BERT-base with a 2-way head (BertConfig()'s widths are the
    published bert-base-uncased config.json's), f32, from BERT_SEED."""
    from transformers import BertConfig, BertForSequenceClassification

    torch.manual_seed(BERT_SEED)
    return BertForSequenceClassification(BertConfig(num_labels=2))


def _bert_toy(n):
    """The reference test's separable toy task at BERT_SEQ: label 1 iff
    token 3 at position 0, int32 columns."""
    rng = np.random.default_rng(SEED + 24)
    ids = rng.integers(4, 30522, size=(n, BERT_SEQ)).astype(np.int32)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    ids[labels == 1, 0] = 3
    return {"input_ids": ids,
            "attention_mask": np.ones((n, BERT_SEQ), np.int32),
            "labels": labels}


def _bert_direct(dev, cols, steps):
    """The oracle of phase 24 (c): the same model, AdamW (optax.adamw's
    numbers), loss and batches, stepped here. Losses and step seconds."""
    from ray_tpu_torch.train.huggingface import (
        ADAMW_BETAS,
        ADAMW_EPS,
        ADAMW_WEIGHT_DECAY,
    )

    model = _bert_init().to(dev).eval()
    opt = torch.optim.AdamW(model.parameters(), lr=5e-5, betas=ADAMW_BETAS,
                            eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    losses, step_s = [], []
    for i in range(steps):
        b = {k: torch.as_tensor(v[i * BERT_BATCH:(i + 1) * BERT_BATCH]
                                ).to(dev) for k, v in cols.items()}
        labels = b.pop("labels")
        t0 = time.perf_counter()
        loss = F.cross_entropy(model(**b).logits, labels.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    del model, opt
    torch.cuda.empty_cache()
    return losses, step_s


def _formats_bert(data, dev):
    """Phase 24 (c): TransformersTrainer fine-tunes BERT-base on the card,
    one worker against the direct loop, then two workers sharing it."""
    from ray_tpu_torch.train import ScalingConfig, TransformersTrainer
    from ray_tpu_torch.train.huggingface import _select_torch_framework

    _select_torch_framework()   # before any transformers import here
    checks, out = {}, {}
    cols = _bert_toy(BERT_STEPS * BERT_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = TransformersTrainer(
        model_init=_bert_init, batch_size=BERT_BATCH, report_every=1,
        device=str(dev),
        datasets={"train": data.from_columns(cols, parallelism=2)}).fit()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    hist = [h for h in res.metrics_history if not h.get("done")]
    losses = [h["loss"] for h in hist]
    direct, step_s = _bert_direct(dev, cols, BERT_STEPS)
    again, _ = _bert_direct(dev, cols, BERT_STEPS)
    checks["c_one_worker_steps"] = [h["step"] for h in hist] == list(
        range(1, BERT_STEPS + 1))
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, direct))
    checks["c_first_loss_bit_equal"] = losses[0] == direct[0]
    checks["c_losses_equal_direct"] = losses == direct or (
        direct != again and rel <= BERT_LOSS_RTOL)
    checks["c_loss_falls"] = losses[-1] < losses[0]
    p50 = _p50(step_s[1:])
    out["one_worker"] = {
        "losses": losses, "direct_losses": direct,
        "direct_again_losses": again,
        "direct_repeats_bit_equal": direct == again,
        "max_rel_diff_to_direct": rel, "bound_rel": BERT_LOSS_RTOL,
        "max_rel_diff_direct_repeat": max(
            abs(x - y) / abs(y) for x, y in zip(again, direct)),
        "fit_s": fit_s, "direct_step_ms_p50": p50 * 1e3,
        "tokens_per_s": BERT_BATCH * BERT_SEQ / p50,
        "peak_memory_GB": peak / 1e9}
    # Two workers on the one card: rank 0's first batch is the first
    # BERT_BATCH rows of its shard (split(2) gives each rank whole blocks).
    cols2 = _bert_toy(2 * BERT_DP_STEPS * BERT_BATCH)
    ds2 = data.from_columns(cols2, parallelism=2)
    shard0 = ds2.split(2)[0]
    first = next(shard0.iter_batches(batch_size=BERT_BATCH))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res2 = TransformersTrainer(
        model_init=_bert_init, batch_size=BERT_BATCH, report_every=1,
        device=str(dev), scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": ds2}).fit()
    fit2_s = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated(dev)
    hist2 = res2.metrics_history
    model = _bert_init().to(dev).eval()
    with torch.no_grad():
        b = {k: torch.as_tensor(v).to(dev) for k, v in first.items()}
        labels = b.pop("labels")
        first_loss = F.cross_entropy(model(**b).logits, labels.long()).item()
    del model
    torch.cuda.empty_cache()
    losses2 = [h["loss"] for h in hist2 if not h.get("done")]
    checks["c_two_workers_finish"] = (
        bool(hist2) and hist2[-1].get("done") is True
        and hist2[-1]["step"] == BERT_DP_STEPS
        and {h.get("rank") for h in hist2} == {0})
    checks["c_two_workers_finite"] = all(np.isfinite(x) for x in losses2)
    checks["c_two_workers_first_loss_equal"] = bool(losses2) and \
        losses2[0] == first_loss
    out["two_workers"] = {"losses": losses2, "direct_first_loss": first_loss,
                          "fit_s": fit2_s, "peak_memory_GB": peak2 / 1e9}
    return checks, out


def phase_formats(dev, card, cfg):
    """Phase 24 (module docstring): Data's pandas, Arrow, fsspec and PIL
    surface, and TransformersTrainer."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    t_phase = time.perf_counter()
    tokens = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, ((TRAINER_STEPS + TRAINER_MORE) * TRAIN_BATCH,
                            TRAIN_LEN + 1))
    checks, out, part_s = {}, {}, {}
    rt.shutdown()
    root = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    rt.init(num_cpus=4)

    def part(name, fn, *args):
        t0 = time.perf_counter()
        c, o = fn(*args)
        part_s[name] = time.perf_counter() - t0
        checks.update(c)
        out[name] = o

    try:
        part("a", _formats_parquet_trainer, data, cfg, dev, tokens, root)
        part("b", _formats_round_trips, data, root)
        part("c", _formats_bert, data, dev)
    finally:
        rt.shutdown()
        data.MemoryFilesystem.clear()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    result = {"phase": "formats", "checks": checks, **out, "part_s": part_s,
              "phase_s": time.perf_counter() - t_phase,
              "temporary_dirs_left": os.path.exists(root), "card": card}
    emit(result)
    failed = [k for k, ok in checks.items() if not ok]
    if failed or result["temporary_dirs_left"]:
        raise AssertionError(f"phase 24 (formats) failed {failed}")
    return result


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


def _run_only(name, armed, dev, card):
    """One phase alone (``--only``), its kernels built at first use:
    ``formats`` is phase 24, ``distributed`` phase 23, ``elastic`` phase 22, ``nodes`` phase 21, ``cluster`` phase 20,
    ``process`` phase 19, ``util`` phase 18, ``tune`` phase 17,
    ``data`` phase 16,
    ``observe`` phase 15; ``rl`` is phase 12, with ``armed`` under the
    flight recorder and its stack sampler for the whole phase (the
    runtime's shutdown inside it leaves them armed), which must have
    sampled while the RL graphs captured."""
    from ray_tpu_torch._private import flight
    from ray_tpu_torch.models import TransformerConfig

    if name == "observe":
        phase_observe(dev, card, TransformerConfig(), ENGINE_LENS, 32)
        return
    if name == "data":
        phase_data(dev, card, TransformerConfig())
        return
    if name == "tune":
        phase_tune(dev, card, TransformerConfig())
        return
    if name == "util":
        phase_util(dev, card, TransformerConfig())
        return
    if name == "process":
        phase_process(dev, card, TransformerConfig())
        return
    if name == "cluster":
        phase_cluster(dev, card, TransformerConfig())
        return
    if name == "nodes":
        phase_nodes(dev, card, TransformerConfig())
        return
    if name == "elastic":
        phase_elastic(dev, card, TransformerConfig())
        return
    if name == "distributed":
        phase_distributed(dev, card, TransformerConfig())
        return
    if name == "formats":
        phase_formats(dev, card, TransformerConfig())
        return
    rec = flight.install(profile=True) if armed else None
    try:
        with contextlib.ExitStack() as stack:
            if armed:
                stack.enter_context(
                    _patched(flight, "uninstall", lambda: None))
            phase_rl(dev, card)
    finally:
        flight.uninstall()
    if armed:
        out = {"phase": "rl_armed", "samples_taken":
               rec.sampler.samples_taken,
               "events_recorded": rec.events_recorded,
               "watchdog_fires": rec.watchdog_fires, "card": card}
        emit(out)
        if not out["samples_taken"]:
            raise AssertionError("the stack sampler took no sample "
                                 "during phase 12")


def _share_bytecode() -> dict:
    """This process and those it starts write and read compiled bytecode
    under build/pycache (module docstring). Returns the prefix and
    whether the environment had turned bytecode writing off."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "pycache")
    was_off = sys.dont_write_bytecode
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return {"pycache_prefix": prefix, "writing_was_off": was_off}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive ray_tpu_torch on one "
                                             "card (module docstring).")
    ap.add_argument("--only",
                    choices=("formats", "distributed", "elastic", "nodes",
                             "cluster", "process", "util", "tune", "data",
                             "observe", "rl"),
                    help="run one phase alone: 24 (formats), "
                         "23 (distributed), "
                         "22 (elastic), 21 (nodes), "
                         "20 (cluster), "
                         "19 (process), "
                         "18 (util), 17 (tune), 16 (data), 15 (observe) or "
                         "12 (rl)")
    ap.add_argument("--armed", action="store_true",
                    help="with --only rl: the flight recorder and its "
                         "stack sampler armed through the phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    emit({"phase": "bytecode", **_share_bytecode()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    if args.only:
        _run_only(args.only, args.armed, dev, card)
        emit({"seconds_total": time.perf_counter() - t_start})
        print(card, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0

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
    phase_serve(dev, card, flagship, ENGINE_LENS, 32)
    phase_trainer(dev, card, flagship)
    phase_observe(dev, card, flagship, ENGINE_LENS, 32)
    phase_data(dev, card, flagship)
    tune = phase_tune(dev, card, flagship)
    util = phase_util(dev, card, flagship)
    phase_process(dev, card, flagship)
    cluster = phase_cluster(dev, card, flagship)
    nodes = phase_nodes(dev, card, flagship)
    elastic = phase_elastic(dev, card, flagship)
    dist = phase_distributed(dev, card, flagship)
    formats = phase_formats(dev, card, flagship)
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
    # Phase 17's launches per step: a Tuner trial's and a workflow
    # segment's (the segments' steps and the evaluation's forward).
    for row in kernels:
        kind = {"flash_attention_fwd[mha]": "fwd_wgmma",
                "flash_attention_bwd_dq": "dq_wgmma",
                "flash_attention_bwd_dkv": "dkv_wgmma"}.get(row["name"])
        if kind is not None:
            row["launches_tune"] = {
                "per_trial_step": tune["a"]["launches_per_trial_step"].get(
                    kind.replace("fwd_", ""), 0.0),
                "per_workflow_segment_step": tune["b"][
                    "launches_per_segment_step"].get(
                    kind.replace("fwd_", ""), 0.0)}
            # Phase 18's: a step in an actor placed by a placement
            # group's strategy, and a @serve.batch batch (forward only).
            row["launches_util"] = {
                "per_step_in_placement_group": util["a"][
                    "launches_per_step"][kind.replace("fwd_", "")],
                "per_serve_batch": util["b"]["launches"][
                    kind.replace("fwd_", "")] / util["b"]["batches"]}
            # Phase 20's: a step relayed through the head from a second
            # driver.
            row["launches_cluster"] = {
                "per_relayed_step": cluster["a"]["launches_per_step"].get(
                    kind.replace("fwd_", ""), 0.0)}
            # Phase 21's: a step in the actor placed on a card node,
            # counted in the node daemon's process.
            row["launches_nodes"] = {
                "per_placed_step": nodes["a"]["launches_per_step"].get(
                    kind.replace("fwd_", ""), 0.0)}
            # Phase 22's: a step of a submitted job, in the actor on the
            # card node the autoscaler launched, counted in that daemon.
            row["launches_elastic"] = {
                "per_job_step": elastic["a"]["launches_per_step"].get(
                    kind.replace("fwd_", ""), 0.0)}
            # Phase 23's: a step in each of two processes whose dp crosses
            # them (gloo on the one card; NCCL, a card each, where there
            # are several), and in each of two whose tp crosses them.
            row["launches_distributed"] = {
                "per_process_step_gloo": [
                    r["adamw"]["launches_per_step"][kind.replace("fwd_", "")]
                    for r in dist["b"]["reports"]],
                "per_process_step_nccl": None if dist["c"] is None else [
                    r["adamw"]["launches_per_step"][kind.replace("fwd_", "")]
                    for r in dist["c"]["reports"]],
                # (f): two processes on the one card whose tp crosses
                # them, each on its n_heads / 2 heads.
                "per_process_step_tp_gloo": [
                    r["adamw"]["launches_per_step"][kind.replace("fwd_", "")]
                    for r in dist["f"]["tp2"]["reports"]]}
            # Phase 24's: a step of the flagship fed from hive-partitioned
            # parquet through a pandas stage.
            row["launches_formats"] = {
                "per_parquet_fed_step": formats["a"]["launches_per_step"]
                .get(kind.replace("fwd_", ""), 0.0)}
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
