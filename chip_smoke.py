#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints one JSON line; any failure raises and the script exits
non-zero without printing a result. Without a CUDA card, or without the
``ray_tpu_torch`` package beside it, it exits non-zero at once.

1. build: compile the flash-attention kernel from ray_tpu_torch/ops/csrc.
2. kernels: the kernel against its plain PyTorch version on the card at
   the flagship's prefill widths (B=4, Hq=8, Hkv 8, 4 or 2, S
   128/512/2048, D=64, causal and not, bf16 and f32), and its time beside
   the plain version's, PyTorch's scaled_dot_product_attention (a
   yardstick the port never calls) and the card's bound.
3. model: the flagship TransformerConfig() (and its GQA variant,
   n_kv_heads=4) serves 4 prompts through prefill_with_cache (the flash
   path) and 32 greedy decode_steps; the kernel must launch n_layers times
   per prefill, and prefill_chunk (plain paged attention) must agree, as
   must the cacheless forward at a length that is no multiple of 128.
4. engine: InferenceEngine answers 8 concurrent greedy requests equal to
   their sequential runs; in f32, its tokens equal the flash path's.

The last lines are the kernels table, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BLOCK_SIZE = 16
KV_HEADS = (8, 4, 2)    # MHA flagship, its GQA variant (phase 3), group 4
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak (H100 SXM)
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth (H100 SXM)
# Kernel vs plain on the card. The error scale of attention output is
# the size of the row it belongs to (|O| of a row shrinks as its keys
# grow), so O is held per row: max|o - ro| over a row, over max|ro| of
# that row. bf16: the plain version rounds each score twice (the product,
# then its scaling) and p once, the kernel rounds p from f32 scores, and
# both round O (relative ulp 2**-8 to 2**-7); a row's error sums many such
# roundings. The limit 2**-5 is 4 to 8 ulps of the row's largest element;
# a dropped 64-key tile reads 20x more (phase 2 checks that it is caught).
# LSE is held per element: bf16 scores rounded by 2**-9 of their size move
# LSE by at most that, and the limit is 2**-8 * (|lse| + 1). f32 sums in
# another order (TF32 off).
O_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
# Flash path vs paged path logits in bf16: |logit| reaches ~5, where a
# bf16 ulp is 1/32; the two attention paths round at different places and
# that propagates through 4 layers, so they agree to a few ulps.
MODEL_LOGIT_TOL = 0.25
RAGGED_LEN = 200   # phase 3's cacheless forward: no multiple of 128


def emit(obj) -> None:
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


def attention_bound(B, Hq, Hkv, S, D, dtype, causal):
    """(bound_ms, bound_by): the larger of operations over the bf16
    tensor-core peak and bytes (q, k, v read once; O, LSE written once)
    over HBM bandwidth."""
    elt = torch.finfo(dtype).bits // 8
    ops = 4.0 * B * Hq * S * S * D
    if causal:
        ops *= (S + 1) / (2.0 * S)   # the pairs a causal mask keeps
    nbytes = elt * (2 * B * Hq * S * D + 2 * B * Hkv * S * D) \
        + 4 * B * Hq * S
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("flash_attention_fwd")
    seconds = time.perf_counter() - t0
    nvcc_s, ptxas = _build.build_info["flash_attention_fwd"]
    emit({"phase": "build", "library": str(path.name),
          "seconds": seconds, "nvcc_seconds": nvcc_s,
          "ptxas": [ln for ln in ptxas.splitlines() if "registers" in ln
                    or "spill" in ln],
          "card": card_line(),
          "device_name": torch.cuda.get_device_name(0)})


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
    """Kernel vs plain at every listed shape; timings at S=2048 and at the
    main path's S=512. Each case also reads a planted fault (the plain
    version with one 64-key tile of V zeroed, i.e. that tile's P.V
    dropped) through the same comparison, and fails unless the check
    flags it."""
    fa = _flash_module()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq, D = 4, 8, 64
    checks = []
    timing = {}
    for Hkv in KV_HEADS:
        for S in (128, 512, 2048):
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn((B, Hq, S, D), generator=gen, device=dev,
                                dtype=torch.float32).to(dtype)
                k = torch.randn((B, Hkv, S, D), generator=gen, device=dev,
                                dtype=torch.float32).to(dtype)
                v = torch.randn((B, Hkv, S, D), generator=gen, device=dev,
                                dtype=torch.float32).to(dtype)
                t0 = 64 * ((S // 2) // 64)
                v_fault = v.clone()
                v_fault[:, :, t0:t0 + 64] = 0
                for causal in (True, False):
                    o, lse = fa._flash_forward(q, k, v, causal)
                    ro, rlse = fa._dense(q, k, v, causal, D ** -0.5)
                    fo, flse = fa._dense(q, k, v_fault, causal, D ** -0.5)
                    torch.cuda.synchronize()
                    err_abs, err_row, err_lse = compare(o, lse, ro, rlse)
                    _, fault_row, _ = compare(fo, flse, ro, rlse)
                    tol = O_ROW_TOL[dtype]
                    ok = (err_row <= tol and err_lse <= 1.0
                          and bool(torch.isfinite(o).all()))
                    checks.append({"Hkv": Hkv, "S": S,
                                   "dtype": str(dtype).split(".")[1],
                                   "causal": causal, "err_o_abs": err_abs,
                                   "err_o_row": err_row, "tol_o_row": tol,
                                   "err_lse_of_limit": err_lse,
                                   "fault_o_row": fault_row, "ok": ok})
                    if not ok or fault_row <= tol:
                        emit({"phase": "kernels", "checks": checks})
                        raise AssertionError(
                            f"flash kernel disagrees with plain, or the "
                            f"check misses a planted fault: {checks[-1]}")
                    if dtype == torch.bfloat16 and causal and S >= 512:
                        timing[f"Hkv{Hkv}_S{S}"] = _time_kernel(
                            fa, q, k, v, err_abs)
    emit({"phase": "kernels", "checks": checks, "timing": timing})
    return timing


def _time_kernel(fa, q, k, v, err_o):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    n = fa.launches
    kernel_ms = cuda_ms(lambda: fa._flash_forward(q, k, v, True))
    fa.launches = n   # timing launches are not the main path's
    plain_ms = cuda_ms(lambda: fa._dense(q, k, v, True, D ** -0.5),
                       iters=5)
    try:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != Hq))
    except TypeError:   # a PyTorch without enable_gqa: pre-expanded K/V
        ke = k.repeat_interleave(Hq // Hkv, dim=1)
        ve = v.repeat_interleave(Hq // Hkv, dim=1)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
    bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, q.dtype, True)
    return {"shape": [B, Hq, Hkv, S, D], "dtype": "bfloat16",
            "causal": True, "max_abs_err": err_o, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    decode_steps, with the flash launch count set to 0 just before.
    Returns (prefill logits, greedy tokens per prompt, launches after the
    prefill, launches after the decodes, tables, tokens, prompt lens)."""
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
    fa.launches = 0
    logits, cache = tm.prefill_with_cache(cfg, params, cache, tok_t, lens,
                                          bt)
    torch.cuda.synchronize()
    after_prefill = fa.launches
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
    return logits, out, after_prefill, fa.launches, bt, tok_t, lens


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
        logits, out, after_prefill, after_all, bt, toks, plens = flash_path(
            cfg, params, prompts, pad_to, decode_steps, dev)
        if after_prefill != cfg.n_layers or after_all != cfg.n_layers:
            raise AssertionError(
                f"{name}: flash kernel launched {after_prefill} times in "
                f"prefill_with_cache and {after_all} in all, expected "
                f"{cfg.n_layers} (one per layer, none in decode)")
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

    # Each request alone, then all at once on a fresh engine with the same
    # weights (a fresh prefix cache, so the concurrent run prefills every
    # prompt in shared batches rather than hitting the sequential run's
    # cached blocks).
    fa.launches = 0
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
    _, flash_tokens, _, _, _, _, _ = flash_path(
        cfg32, params32, prompts3, pad_to, new_tokens - 1, dev)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the ray_tpu_torch package is missing ({exc}); "
              f"run from the repository root", file=sys.stderr)
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
    model = phase_model(dev, flagship, model_lens, 512, 32)
    phase_engine(dev, card, flagship,
                 [16, 150, 290, 430, 570, 710, 850, 1000], model_lens, 512,
                 32)

    replaces = {
        "mha": "ray_tpu/ops/flash_attention.py:341 (_attn_kernel via "
               "_flash_forward)",
        "gqa": "ray_tpu/ops/flash_attention.py:306 (_attn_kernel via "
               "_flash_forward_grouped)",
    }
    kernels = []
    for name, Hkv in (("mha", model["mha"]["n_kv_heads"]),
                      ("gqa", model["gqa"]["n_kv_heads"])):
        t = timing[f"Hkv{Hkv}_S2048"]
        kernels.append({
            "name": f"flash_attention_fwd[{name}]",
            "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "replaces": replaces[name],
            "launches": model[name]["launches"],
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
