#!/usr/bin/env python3
"""A/B timings of the hand-written flash kernels on one NVIDIA card.

Builds the tensor-core forward and backward libraries
(``ray_tpu_torch/ops/csrc/flash_attention_{fwd,bwd}_wgmma.cu``) of several
designs, prints each build's ptxas registers and spills, holds each design's
forward against this tree's (O per row within O_ROW_TOL, LSE within
LSE_TOL) and reports this tree's against the plain version with the
kernels' rounding points (``_dense_kernel``), and times the forward, dQ
and dK/dV of every design against this tree's on the same inputs, in
turns (other designs, this tree, this tree, the others in reverse),
through CUDA graphs. bf16, B=4, H=8, S=2048, causal, head_dim 64, 128 and
256 (each variant at the widths it changes).

With ``--parent``, the parent's and this tree's kernels are also compared
bit for bit: at every width the backward kernels (dQ with its delta, and
dK/dV) on the same bf16 inputs, and at head_dim 64 and 256, where the
scale is a power of two, the forward; and both forwards' digests are
printed for the cases of ``ray_tpu_torch.testing.FWD_DIGESTS`` (bf16 and
f16, causal and not, on inputs that keep q * scale exact in f16), which
must equal each other and, where recorded, the digests there.

The designs:
- ``tree``: this checkout's sources, the kernels the port launches;
- ``parent``: the sources under ``--parent DIR`` (a ``git archive`` of an
  earlier commit whose C entry points take a dtype code, as this tree's
  do: head_dim 64, 128 and 256);
- textual variants of this tree's sources (``VARIANTS``): the forward with
  32-key tiles at head_dim 256, the forward with the general masking test
  at every width, and both libraries with a 384-thread block whose
  producer warpgroup hands its registers to the consumers (setmaxnreg 24 /
  240), the layout before this one.

With ``--wide``, the same for the tensor-core wide kernels
(``flash_attention_wide_wgmma.cu``: the forward, dQ and dK/dV for
head_dim above 256) at head_dim 512, 384, 1024, 1032 and 2048 (above
1024 the forward streams Q), against ``WIDE_VARIANTS``, each at the
widths of ``WIDE_VARIANT_DIMS``: dK/dV with 256-column chunks (each
warpgroup owning 128 columns of dK and dV, as first written), the forward
with a 6-slot K ring (Q held up to head_dim 768) and dQ with 128-column
chunks (each warpgroup owning 64 columns: 3x the real work at D = 512
against 1.67x) at 512 and 384; the forward streaming Q at every width
(the streamed instance at 512 and 1024, where this tree holds Q); and
above 1024 the forward whose consumers scale each streamed Q box in
shared memory (a proxy fence and a named barrier per box) in place of
this tree's pre-pass. dQ (with its delta) and dK/dV of each design are
held against this tree's (per row within GRAD_ROW_TOL; delta against
rowsum(dO * O) at testing.delta_error's limit), dK/dV on delta from this
tree's dQ kernel; whether a forward equals this tree's bit for bit is
printed. Above 1024 the CUDA-core wide kernels (``flash_attention_
wide.cu``, the ones the rule took there before) run in turns too (one
call each by CUDA events: they take up to seconds), held against the
plain versions. With ``--parent`` (an earlier commit's
``flash_attention_wide_wgmma.cu``, whose forward takes no work buffer),
the parent's and this tree's forward (O and LSE), dQ, delta and dK/dV are
first compared bit for bit at head_dim 264, 512 and 1024 in bf16 and
f16, causal and not, and the parent is timed beside this tree up to
1024.

With ``--wide-f32``, the same for the f32 wide kernels
(``flash_attention_wide_f32.cu``) on f32 inputs at head_dim 512 and 384,
against ``WIDE_F32_VARIANTS``: dK/dV with 128 columns of dK and dV a
block (2.5x the real work at D = 512 against 1.5x, 64 f32 of them a
thread, as first written), all three kernels with a 4-stage copy ring,
and dQ with 256 columns a block (64 f32 of dQ a thread, 1.67x the real
work at D = 512 against 1x for this tree's 512).

With ``--f32``, the f32 forward and backward pairs up to head_dim 256 on
f32 inputs at head_dim 64, 128 and 256: the earlier CUDA-core kernels
(``flash_attention_fwd.cu``, ``flash_attention_bwd.cu``), the wide
instances of ``flash_attention_wide_f32.cu`` called through their C entry
points at those widths, this tree's tiled kernels (the same library's
tiled instances) and ``F32_TILED_VARIANTS`` (textual edits of those
instances), each held against the plain versions (the forward's O and LSE
against ``_dense_kernel``; dQ also against the float64 formula, delta
against rowsum(dO * O)) and timed in turns beside SDPA (forward, and
backward) and the bound. With ``--parent`` (an earlier commit's
``flash_attention_wide_f32.cu``), the wide forward (O and LSE), dQ, delta
and dK/dV of both are compared bit for bit at head_dim 264, 1032 and 512
and timed at 512. Then the CUDA-core wide kernels
(``flash_attention_wide.cu``: bf16/f16 above head_dim 1024) at head_dim
1032 and 2048 in bf16, held against the plain versions and timed once
each beside SDPA and the bound.

Run from the repository root: ``python3 flash_ab.py --parent DIR``
(``--variants ""`` builds no textual variant), ``python3 flash_ab.py
--wide [--parent DIR]``, ``python3 flash_ab.py --wide-f32`` or
``python3 flash_ab.py --f32 [--parent DIR]``. Prints one JSON line per
build, check and timing, then the card's name and power limit. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from ray_tpu_torch import testing
from ray_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_ab"
LIBS = ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma")
SETMAXNREG = '''
template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kRegs));
}
}  // namespace hopper'''
# name -> {file: [(old, new), ...]}; every copy of each old text in the
# file is replaced, and there must be one at least.
VARIANTS = {
    "fwd_n32": {"flash_attention_fwd_wgmma.cu": [
        ("kBlockN = kD == 256 ? 64 : 128;",
         "kBlockN = kD == 256 ? 32 : 128;")]},
    "fwd_general_mask": {"flash_attention_fwd_wgmma.cu": [
        ("if (kBlockN < kBlockM && causal && k0 > wg_row0 + 63) {",
         "if (causal && k0 > wg_row0 + 63) {"),
        ("        kBlockN == kBlockM\n"
         "            ? kb == n_kb - 1 && (causal || sk % kBlockN != 0)\n"
         "            : (causal && k0 + kBlockN - 1 > wg_row0) || "
         "k0 + kBlockN > sk;",
         "        (causal && k0 + kBlockN - 1 > wg_row0) || "
         "k0 + kBlockN > sk;")]},
    "setmaxnreg384": {
        "hopper_tma_wgmma.cuh": [("}  // namespace hopper", SETMAXNREG)],
        "flash_attention_fwd_wgmma.cu": [
            ("kConsumerThreads + 32;", "kConsumerThreads + 128;"),
            ("  if (threadIdx.x >= kConsumerThreads) {\n",
             "  if (threadIdx.x >= kConsumerThreads) {\n"
             "    regs_dealloc<24>();\n"),
            ("  const int wg = threadIdx.x / 128;\n",
             "  regs_alloc<240>();\n  const int wg = threadIdx.x / 128;\n")],
        "flash_attention_bwd_wgmma.cu": [
            ("kConsumerThreads + 32;", "kConsumerThreads + 128;"),
            ("  if (threadIdx.x >= kConsumerThreads) {\n",
             "  if (threadIdx.x >= kConsumerThreads) {\n"
             "    regs_dealloc<24>();\n"),
            ("  const int wg = threadIdx.x / 128;\n",
             "  regs_alloc<240>();\n  const int wg = threadIdx.x / 128;\n"),
            ("    const int p_lane = threadIdx.x - kConsumerThreads;\n",
             "    const int p_lane = threadIdx.x - kConsumerThreads;\n"
             "    if (p_lane >= 32) return;\n")]},
}
WIDE_SOURCE = "flash_attention_wide_wgmma.cu"
WIDE_VARIANTS = {
    "wide_dkv_chunk256": {WIDE_SOURCE: [
        ("constexpr int kDkvChunk = 128;", "constexpr int kDkvChunk = 256;")]},
    "wide_fwd_kring6": {WIDE_SOURCE: [
        ("constexpr int kFwdKStages = 4;", "constexpr int kFwdKStages = 6;"),
        ("constexpr int kFwdResidentMaxD = 1024;",
         "constexpr int kFwdResidentMaxD = 768;")]},
    "wide_dq_chunk128": {WIDE_SOURCE: [
        ("constexpr int kDqChunk = 256;", "constexpr int kDqChunk = 128;")]},
    "wide_fwd_stream_q": {WIDE_SOURCE: [
        ("constexpr int kFwdResidentMaxD = 1024;",
         "constexpr int kFwdResidentMaxD = 256;")]},
    "wide_fwd_scale_in_place": {WIDE_SOURCE: [
        ("  if (!kResident) {\n    // The streamed boxes arrive as they are:",
         "  if (false) {\n    // The streamed boxes arrive as they are:"),
        ("      mbar_wait(k_full(s), parity_of<kFwdKStages>(kn));\n",
         "      mbar_wait(k_full(s), parity_of<kFwdKStages>(kn));\n"
         "      if (!kResident) {\n"
         "        uint4* box =\n"
         "            reinterpret_cast<uint4*>(smem + (qbox - base));\n"
         "        for (int i = tid; i < kBox / 16; i += kFwdConsumers) {\n"
         "          box[i] = scale4<T>(box[i], round_to<T>(scale));\n"
         "        }\n"
         "        fence_proxy_async();\n"
         "        named_barrier_sync(1, kFwdConsumers);\n"
         "      }\n")]},
}
# The head_dims each wide variant runs at, and the kernels it changes.
WIDE_VARIANT_SCOPE = {"wide_dkv_chunk256": ((512, 384, 2048), ("dkv",)),
                      "wide_fwd_kring6": ((512, 384), ("fwd",)),
                      "wide_dq_chunk128": ((512, 384), ("dq",)),
                      "wide_fwd_stream_q": ((512, 1024), ("fwd",)),
                      "wide_fwd_scale_in_place": ((1032, 2048), ("fwd",))}
WIDE_F32_SOURCE = "flash_attention_wide_f32.cu"
WIDE_F32_VARIANTS = {
    "f32_dkv_cols128": {WIDE_F32_SOURCE: [
        ("using DkvWide = DkvShape<64, 256, 32>;",
         "using DkvWide = DkvShape<64, 128, 32>;")]},
    "f32_stages4": {WIDE_F32_SOURCE: [
        ("constexpr int kStages = 3;", "constexpr int kStages = 4;")]},
    "f32_dq_cols256": {WIDE_F32_SOURCE: [
        ("using DqWide = DqShape<64, 512, 32, false>;",
         "using DqWide = DqShape<64, 256, 32, false>;")]},
}
# --f32: the f32 forward and backward pairs at head_dim up to 256, and
# textual variants of this tree's tiled instances: dK/dV at D <= 128 with
# 128 keys a block (128 f32 of dK and dV a thread, 16-column boxes), dQ at
# D <= 128 with 64 rows a block (32 f32 of dQ a thread), dQ at D <= 64
# with 16-column boxes; the forward at D <= 64 with 64-key tiles (an 8 x 4
# score tile a thread) or with two 64-key V boxes a tile, at D <= 128
# with 64-key tiles or with 64 rows a block (the wide instance's layout
# at 128 columns), and at every D <= 256 with Q re-streamed and re-scaled
# for every key tile, as the wide instance does (at 256: the wide
# instance itself). F32_VARIANT_SCOPE: the head_dims and kernels each
# changes.
F32_LIB = "flash_attention_wide_f32"
F32_DIMS = (64, 128, 256)
F32_TILED_VARIANTS = {
    "tiled_dkv128_keys128": {WIDE_F32_SOURCE: [
        ("using DkvTiled128 = DkvShape<64, 128, 32>;",
         "using DkvTiled128 = DkvShape<128, 128, 16>;")]},
    "tiled_dq128_rows64": {WIDE_F32_SOURCE: [
        ("using DqTiled128 = DqShape<128, 128, 32, true>;",
         "using DqTiled128 = DqShape<64, 128, 32, true>;")]},
    "tiled_dq64_box16": {WIDE_F32_SOURCE: [
        ("using DqTiled64 = DqShape<128, 64, 32, true>;",
         "using DqTiled64 = DqShape<128, 64, 16, true>;")]},
    # 256 rows: 64 dQ accumulators a thread at D <= 64, but 256 floats of
    # S, dP and its per-box partials; 16-column boxes to fit 227 KB.
    "tiled_dq64_rows256": {WIDE_F32_SOURCE: [
        ("using DqTiled64 = DqShape<128, 64, 32, true>;",
         "using DqTiled64 = DqShape<256, 64, 16, true>;")]},
}
F32_FWD_VARIANTS = {
    "fwd64_keys64": {WIDE_F32_SOURCE: [
        ("using FwdTiled64 = FwdShape<128, 128, 64, 128, true>;",
         "using FwdTiled64 = FwdShape<128, 64, 64, 64, true>;")]},
    "fwd64_vkeys64": {WIDE_F32_SOURCE: [
        ("using FwdTiled64 = FwdShape<128, 128, 64, 128, true>;",
         "using FwdTiled64 = FwdShape<128, 128, 64, 64, true>;")]},
    "fwd128_keys64": {WIDE_F32_SOURCE: [
        ("using FwdTiled128 = FwdShape<128, 128, 128, 32, true>;",
         "using FwdTiled128 = FwdShape<128, 64, 128, 32, true>;")]},
    "fwd128_rows64": {WIDE_F32_SOURCE: [
        ("using FwdTiled128 = FwdShape<128, 128, 128, 32, true>;",
         "using FwdTiled128 = FwdShape<64, 128, 128, 32, true>;")]},
    "fwd_stream_q": {WIDE_F32_SOURCE: [
        ("using FwdTiled64 = FwdShape<128, 128, 64, 128, true>;",
         "using FwdTiled64 = FwdShape<128, 128, 64, 128, false>;"),
        ("using FwdTiled128 = FwdShape<128, 128, 128, 32, true>;",
         "using FwdTiled128 = FwdShape<128, 128, 128, 32, false>;"),
        ("using FwdTiled256 = FwdShape<64, 128, 256, 32, true>;",
         "using FwdTiled256 = FwdWide;")]},
}
F32_TILED_VARIANTS.update(F32_FWD_VARIANTS)
F32_VARIANT_SCOPE = {"tiled_dkv128_keys128": ((128,), ("dkv",)),
                     "tiled_dq128_rows64": ((128,), ("dq",)),
                     "tiled_dq64_box16": ((64,), ("dq",)),
                     "tiled_dq64_rows256": ((64,), ("dq",)),
                     "fwd64_keys64": ((64,), ("fwd",)),
                     "fwd64_vkeys64": ((64,), ("fwd",)),
                     "fwd128_keys64": ((128,), ("fwd",)),
                     "fwd128_rows64": ((128,), ("fwd",)),
                     "fwd_stream_q": ((64, 128, 256), ("fwd",))}
F32_TIMING = {"iters": 8, "replays": 5}
# The CUDA-core wide kernels (flash_attention_wide.cu: bf16/f16 above
# 1024), timed once each.
WIDE_CC_DIMS = (1032, 2048)
# The head_dims where a variant's code differs from this tree's.
VARIANT_DIMS = {"fwd_n32": (256,), "fwd_general_mask": (64, 128)}
DIMS = (64, 128, 256)
WIDE_DIMS = (512, 384, 1024, 1032, 2048)
WIDE_F32_DIMS = (512, 384)
# Above 1024: fewer graph replays (a call takes milliseconds to tens of
# them), and the CUDA-core wide kernels (a call takes up to seconds) one
# call each by events.
WIDE_HEAVY_TIMING = {"iters": 4, "replays": 3}
# The parent's and this tree's tensor-core wide kernels bit for bit:
# (head_dim, B, H, Sq, Sk).
WIDE_BIT_CASES = ((264, 2, 2, 200, 200), (512, 4, 8, 2048, 2048),
                  (1024, 2, 2, 77, 131))
B, H, S = 4, 8, 2048
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def emit(obj):
    print(json.dumps(obj), flush=True)


def _sources(name, parent):
    """Materialise a design's csrc directory under build/flash_ab/."""
    src = (Path(parent) if name == "parent" else ROOT) \
        / "ray_tpu_torch" / "ops" / "csrc"
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, edits in {**VARIANTS, **WIDE_VARIANTS, **WIDE_F32_VARIANTS,
                         **F32_TILED_VARIANTS}.get(name, {}).items():
        path = dst / fname
        text = path.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {fname} has no {old[:60]!r}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def build(names, parent, libraries=LIBS):
    """nvcc for every design's libraries at once -> {name: {library:
    loaded library}}; emits each build's ptxas registers and spills."""
    running = []
    for name in names:
        d = _sources(name, parent)
        for lib in libraries:
            cmd = [_build._nvcc(), *_build.nvcc_flags(lib), "-o",
                   str(d / f"{lib}.so"), str(d / f"{lib}.cu")]
            running.append((name, lib, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    libs = {}
    for name, lib, d, proc in running:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{err}")
        emit({"build": name, "library": lib,
              "ptxas": cs.ptxas_summary(err)})
        libs.setdefault(name, {})[lib] = ctypes.CDLL(str(d / f"{lib}.so"))
    return libs


def entry_points(name, libs):
    """(forward, dQ, dK/dV) C functions of a design, argument types set
    (this tree's tensor-core wide forward takes a work buffer after lse,
    the parent's does not)."""
    if "flash_attention_wide_f32" in libs:
        wide = libs["flash_attention_wide_f32"]
        fwd = wide.flash_attention_fwd_wide_f32
        dq = wide.flash_attention_bwd_dq_wide_f32
        dkv = wide.flash_attention_bwd_dkv_wide_f32
    elif "flash_attention_wide_wgmma" in libs:
        wide = libs["flash_attention_wide_wgmma"]
        fwd = wide.flash_attention_fwd_wide_wgmma
        dq = wide.flash_attention_bwd_dq_wide_wgmma
        dkv = wide.flash_attention_bwd_dkv_wide_wgmma
    else:
        fwd = libs["flash_attention_fwd_wgmma"].flash_attention_fwd_wgmma
        bwd = libs["flash_attention_bwd_wgmma"]
        dq = bwd.flash_attention_bwd_dq_wgmma
        dkv = bwd.flash_attention_bwd_dkv_wgmma
    work = _takes_work(name, libs)
    fwd.argtypes = [_VP] * (6 if work else 5) + [_CI] * 6 + [_CF, _CI, _CI,
                                                             _VP]
    for fn in (dq, dkv):
        fn.argtypes = [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP]
    for fn in (fwd, dq, dkv):
        fn.restype = _CI
    return fwd, dq, dkv


def _takes_work(name, libs):
    """Whether a design's forward entry point takes a work buffer: this
    tree's tensor-core wide forward and its variants."""
    return "flash_attention_wide_wgmma" in libs and name != "parent"


def kinds(name):
    """The kernels a design changes against this tree: all three for the
    tree, the parent and the CUDA-core wide kernels (``cuda_core``), else
    those of the libraries its edits touch."""
    if name in ("tree", "parent", "cuda_core"):
        return ("fwd", "dq", "dkv")
    if name in WIDE_VARIANTS:
        return WIDE_VARIANT_SCOPE[name][1]
    if name in WIDE_F32_VARIANTS:
        return {"f32_dkv_cols128": ("dkv",), "f32_dq_cols256": ("dq",),
                "f32_stages4": ("fwd", "dq", "dkv")}[name]
    files = VARIANTS[name]
    return (("fwd",) if "flash_attention_fwd_wgmma.cu" in files else ()) + \
        (("dq", "dkv") if "flash_attention_bwd_wgmma.cu" in files else ())


def calls(name, fns, t, work=False, causal=True):
    """Closures launching a design's three kernels on the tensors t
    (``work``: the forward takes t's work buffer after lse)."""
    fwd, dq, dkv = fns
    B, H, Sq, D = t["q"].shape
    Sk = t["k"].shape[2]
    code = cs._flash_module()._DTYPE_CODE[t["q"].dtype]
    p = {k: v.data_ptr() for k, v in t.items()}
    fwd_out = (p["o2"], p["l2"]) + ((p["work"],) if work else ())
    tail = (D ** -0.5, int(causal), code)

    def run(fn, *args):
        err = fn(*args, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")

    return {
        "fwd": lambda i: run(fwd, p["q"], p["k"], p["v"], *fwd_out,
                             B, H, H, Sq, Sk, D),
        "dq": lambda i: run(dq, p["q"], p["k"], p["v"], p["o"], p["do"],
                            p["lse"], p["dq2"], p["delta2"], B * H, Sq, Sk,
                            D),
        "dkv": lambda i: run(dkv, p["q"], p["k"], p["v"], p["do"], p["lse"],
                             p["delta"], p["dk2"], p["dv2"], B * H, Sq, Sk,
                             D),
    }


def _cdiv(a, b):
    return -(-a // b)


def wide_tma_bytes(kind, B, H, S, D, causal=True):
    """Bytes the tensor-core wide kernel ``kind`` ("fwd", "dq" or "dkv")
    copies into shared memory by TMA at [B, H, S, D] (Sq = Sk = S), as its
    loops issue them: every box counted in full (a box past D lands as
    zeros), each re-read counted again. These come from L2 (or HBM where
    L2 misses); the bound counts each input once."""
    box, rbox = 64 * 128, 32 * 128       # 64 or 32 rows x 64 columns of T
    nb = _cdiv(D, 64)
    total = 0
    for row0 in range(0, S, 64):        # the CTA's 64 query rows or keys
        last = min(row0 + 64, S) - 1
        if kind == "fwd":               # per 256 columns of O
            held = D <= 1024
            tiles = min(_cdiv(S, 64), last // 64 + 1) if causal \
                else _cdiv(S, 64)
            once = nb * box if held else 0
            per_tile = nb * box * (1 if held else 2) + 4 * box  # K (Q), V
            total += _cdiv(D, 256) * (once + tiles * per_tile)
            continue
        held = D <= 512
        width = 4 if kind == "dq" else 2    # 64-column boxes of a chunk
        for c in range(_cdiv(D, 64 * width)):
            n_items = c * width + max(0, nb - c * width - width) + width
            once = 2 * nb * box if held else 0
            if kind == "dq":                # delta's pass, then key tiles
                once += n_items * box * (1 if held else 2)
                tiles = min(_cdiv(S, 32), last // 32 + 1) if causal \
                    else _cdiv(S, 32)
            else:                           # query tiles from the diagonal
                tiles = _cdiv(S, 32) - (min(row0 // 32, _cdiv(S, 32))
                                        if causal else 0)
            per_item = 2 * rbox + (0 if held else 2 * box)
            total += once + tiles * n_items * per_item
    return total * B * H


def cuda_core_calls(t):
    """Closures launching the CUDA-core wide forward, dQ and dK/dV
    (flash_attention_wide.cu: its dQ writes no delta, its dK/dV reads O)
    on the tensors t through their C entry points."""
    fa = cs._flash_module()
    B, H, S, D = t["q"].shape
    fwd, dq, dkv = (fa._kernel_fn("flash_attention_wide", name) for name in (
        "flash_attention_fwd_wide", "flash_attention_bwd_dq_wide",
        "flash_attention_bwd_dkv_wide"))
    p = {k: v.data_ptr() for k, v in t.items()}
    tail = (D ** -0.5, 1, fa._DTYPE_CODE[t["q"].dtype])

    def run(fn, *args):
        err = fn(*args, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cuda_core: launch failed ({err})")

    bwd_in = (p["q"], p["k"], p["v"], p["o"], p["do"], p["lse"])
    return {"fwd": lambda i: run(fwd, p["q"], p["k"], p["v"], p["o2"],
                                 p["l2"], B, H, H, S, S, D),
            "dq": lambda i: run(dq, *bwd_in, p["dq2"], None, B * H, S, S, D),
            "dkv": lambda i: run(dkv, *bwd_in, p["dk2"], p["dv2"], B * H, S,
                                 S, D)}


def wide_inputs(gen, dev, dtype, B, H, Sq, Sk, D, causal):
    """Seeded inputs, this tree's forward O and LSE and dQ's delta (through
    the wrapper, counts kept), and output buffers (a work buffer for the
    tensor-core wide forward)."""
    fa = cs._flash_module()
    q, do = (torch.randn((B, H, Sq, D), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    with cs._counts_kept(fa):
        o, lse = fa._flash_forward(q, k, v, causal)
        delta = fa._launch_dq(q, k, v, o, lse, do, causal, D ** -0.5)[1]
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse,
            "delta": delta, "o2": torch.empty_like(q),
            "l2": torch.empty_like(lse), "dq2": torch.empty_like(q),
            "delta2": torch.empty_like(lse), "dk2": torch.empty_like(k),
            "dv2": torch.empty_like(v), "work": torch.empty_like(q)}


def wide_same_bits(fns, libs, gen, dev):
    """The parent's and this tree's tensor-core wide forward (O and LSE),
    dQ (with delta) and dK/dV bit for bit at WIDE_BIT_CASES, bf16 and f16,
    causal and not (the full-size case causal only); raises where any
    differs."""
    for D, B_, H_, Sq, Sk in WIDE_BIT_CASES:
        for dtype in (torch.bfloat16, torch.float16):
            for causal in (True, False):
                if Sq == S and not causal:
                    continue
                t = wide_inputs(gen, dev, dtype, B_, H_, Sq, Sk, D, causal)
                outs = {}
                for n in ("parent", "tree"):
                    run = calls(n, fns[n], t, _takes_work(n, libs[n]),
                                causal)
                    for kind in ("fwd", "dq", "dkv"):
                        run[kind](0)
                    torch.cuda.synchronize()
                    outs[n] = [t[x].clone() for x in (
                        "o2", "l2", "dq2", "delta2", "dk2", "dv2")]
                same = dict(zip(("o", "lse", "dq", "delta", "dk", "dv"), (
                    torch.equal(a, b) for a, b in zip(outs["parent"],
                                                      outs["tree"]))))
                emit({"check": "parent vs tree, bit for bit", "D": D,
                      "dtype": cs._dtype_name(dtype), "causal": causal,
                      "shape": [B_, H_, Sq, Sk], "same": same})
                if not all(same.values()):
                    raise AssertionError(f"D={D}: the parent's and this "
                                         f"tree's wide kernels differ")
                del t, outs
    torch.cuda.empty_cache()


def same_bits(runs, t, D):
    """The parent's and this tree's kernels on the same inputs, bit for
    bit: dQ (with delta) and dK/dV at every width, the forward at the
    power-of-two scales (D 64, 256). Emits what matched; raises where a
    kernel that must match does not."""
    outs = {}
    for n in ("parent", "tree"):
        for kind, names in (("fwd", ("o2", "l2")), ("dq", ("dq2", "delta2")),
                            ("dkv", ("dk2", "dv2"))):
            runs[n][kind](0)
            torch.cuda.synchronize()
            outs[n, kind] = [t[x].clone() for x in names]
    same = {kind: all(torch.equal(a, b) for a, b in zip(
        outs["parent", kind], outs["tree", kind]))
        for kind in ("fwd", "dq", "dkv")}
    emit({"check": "parent vs tree, bit for bit", "D": D, "same": same})
    must = ("dq", "dkv") + (("fwd",) if D in (64, 256) else ())
    if not all(same[kind] for kind in must):
        raise AssertionError(f"D={D}: the parent's and this tree's kernels "
                             f"differ where they must not: {same}")


def digests(fns, dev):
    """Forward digests of the parent and this tree at the cases of
    testing.FWD_DIGESTS (testing.digest_inputs: seeded, GQA, ragged
    lengths, q kept where q * scale is exact), which must match; then the
    same seeds without that nudge, reported only: there f16's products
    below 2**-14 lose bits (``inexact_q`` counts them), as the reference's
    do, and the two designs may differ."""
    fa = cs._flash_module()
    found = {}
    B, Hq, Hkv, Sq, Sk = testing.FWD_DIGEST_SHAPE
    for nudge in (True, False):
        for dtype in (torch.bfloat16, torch.float16):
            for D in (64, 256):
                q, k, v = testing.digest_inputs(D, dtype, dev, nudge)
                scale_t = torch.tensor(D ** -0.5, dtype=dtype).float()
                inexact = int(((q.float() * scale_t).to(dtype).float()
                               / scale_t != q.float()).sum())
                for causal in (True, False):
                    key = (f"{cs._dtype_name(dtype)}-D{D}-"
                           f"{'causal' if causal else 'full'}")
                    got = {}
                    for n in ("parent", "tree"):
                        o = torch.empty_like(q)
                        lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                                          device=dev)
                        err = fns[n][0](
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, Hq, Hkv, Sq,
                            Sk, D, D ** -0.5, int(causal),
                            fa._DTYPE_CODE[dtype],
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{n}: launch failed ({err})")
                        torch.cuda.synchronize()
                        got[n] = testing.tensor_digest(o, lse)
                    same = got["parent"] == got["tree"]
                    if not nudge:
                        emit({"digest_unnudged": key, "inexact_q": inexact,
                              "same": same})
                        continue
                    recorded = testing.FWD_DIGESTS.get(key)
                    emit({"digest": key, **got, "inexact_q": inexact,
                          "recorded": recorded})
                    found[key] = got["parent"]
                    if not same or (recorded is not None
                                    and recorded != got["tree"]):
                        raise AssertionError(f"{key}: forward digests "
                                             f"differ")
    emit({"FWD_DIGESTS": found})


def dkv_check(runs, others, t, D):
    """This tree's dK/dV against the plain backward, and each design's
    against this tree's (``cuda_core``, the CUDA-core wide kernels, against
    the plain one), per row within GRAD_ROW_TOL."""
    fa = cs._flash_module()
    runs["tree"]["dkv"](0)
    torch.cuda.synchronize()
    tk, tv = t["dk2"].clone(), t["dv2"].clone()
    ref = fa._dense_backward(t["q"], t["k"], t["v"], t["o"], t["lse"],
                             t["do"], True, D ** -0.5)
    tol = cs.GRAD_ROW_TOL[t["q"].dtype]
    err = max(cs.grad_row_error(g, r) for g, r in zip((tk, tv), ref[1:]))
    emit({"check": "tree dK/dV vs plain", "D": D, "err_row": err,
          "tol_row": tol})
    for n in others:
        runs[n]["dkv"](0)
        torch.cuda.synchronize()
        against = "plain" if n == "cuda_core" else "tree"
        err = max(cs.grad_row_error(g, r)
                  for g, r in zip((t["dk2"], t["dv2"]),
                                  ref[1:] if n == "cuda_core" else (tk, tv)))
        emit({"check": f"{n} dK/dV vs {against}", "D": D, "err_row": err,
              "tol_row": tol})
        if not err <= tol:
            raise AssertionError(f"{n} at D={D}: dK/dV disagrees with "
                                 f"{against}")


def dq_check(runs, others, t, D):
    """This tree's dQ against the plain backward and its delta against
    rowsum(dO * O), and each design's dQ and delta against this tree's:
    dQ per row within GRAD_ROW_TOL, delta at testing.delta_error's limit
    (``cuda_core``, the CUDA-core wide kernels, whose dQ writes no delta:
    its dQ against the plain one)."""
    fa = cs._flash_module()
    runs["tree"]["dq"](0)
    torch.cuda.synchronize()
    tq = t["dq2"].clone()
    ref = fa._dense_backward(t["q"], t["k"], t["v"], t["o"], t["lse"],
                             t["do"], True, D ** -0.5)[0]
    tol = cs.GRAD_ROW_TOL[t["q"].dtype]
    emit({"check": "tree dQ vs plain", "D": D,
          "err_row": cs.grad_row_error(tq, ref), "tol_row": tol,
          "err_delta_of_limit": testing.delta_error(t["delta2"], t["do"],
                                                    t["o"])})
    for n in others:
        runs[n]["dq"](0)
        torch.cuda.synchronize()
        if n == "cuda_core":
            err = cs.grad_row_error(t["dq2"], ref)
            emit({"check": "cuda_core dQ vs plain", "D": D, "err_row": err,
                  "tol_row": tol})
            if not err <= tol:
                raise AssertionError(f"cuda_core at D={D}: dQ disagrees with "
                                     f"plain")
            continue
        err = cs.grad_row_error(t["dq2"], tq)
        err_delta = testing.delta_error(t["delta2"], t["do"], t["o"])
        emit({"check": f"{n} dQ vs tree", "D": D, "err_row": err,
              "tol_row": tol, "err_delta_of_limit": err_delta})
        if not (err <= tol and err_delta <= 1.0):
            raise AssertionError(f"{n} at D={D}: dQ or its delta disagrees "
                                 f"with this tree's kernel")


def _f32_fns(lib, suffix):
    """(forward, dQ, dK/dV) C functions of an f32 library, argument types
    set."""
    fns = [getattr(lib, f"flash_attention_fwd{suffix}")]
    fns[0].argtypes = [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP]
    for kind in ("dq", "dkv"):
        fns.append(getattr(lib, f"flash_attention_bwd_{kind}{suffix}"))
        fns[-1].argtypes = [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP]
    for fn in fns:
        fn.restype = _CI
    return fns


def f32_calls(name, lib, suffix, t):
    """Closures launching the forward (MHA), dQ (with delta) and dK/dV (on
    this tree's delta) of an f32 design through its C entry points, into
    t's output buffers."""
    fwd, dq, dkv = _f32_fns(lib, suffix)
    B, H, Sq, D = t["q"].shape
    Sk = t["k"].shape[2]
    p = {k: v.data_ptr() for k, v in t.items() if torch.is_tensor(v)}
    tail = (D ** -0.5, int(t["causal"]), 0)

    def run(fn, *args):
        err = fn(*args, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")

    return {"fwd": lambda i: run(fwd, p["q"], p["k"], p["v"], p["o2"],
                                 p["l2"], B, H, H, Sq, Sk, D),
            "dq": lambda i: run(dq, p["q"], p["k"], p["v"], p["o"], p["do"],
                                p["lse"], p["dq2"], p["delta2"], B * H, Sq,
                                Sk, D),
            "dkv": lambda i: run(dkv, p["q"], p["k"], p["v"], p["do"],
                                 p["lse"], p["delta"], p["dk2"], p["dv2"],
                                 B * H, Sq, Sk, D)}


def old_calls(t):
    """The earlier f32 kernels (flash_attention_fwd.cu; flash_attention_
    bwd.cu's pair, computing delta itself) through their C entry points,
    into t's output buffers."""
    fa = cs._flash_module()
    B, H, Sq, D = t["q"].shape
    Sk = t["k"].shape[2]
    fwd_lib, lib, _ = fa._LIBRARIES["simt"]
    fns = {kind: fa._kernel_fn(lib, f"flash_attention_bwd_{kind}")
           for kind in ("dq", "dkv")}
    fns["fwd"] = fa._kernel_fn(fwd_lib, "flash_attention_fwd")
    p = {k: v.data_ptr() for k, v in t.items() if torch.is_tensor(v)}
    tail = (D ** -0.5, int(t["causal"]), 0)

    def run(kind, *args):
        err = fns[kind](*args, *tail,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {kind}: launch failed ({err})")

    bwd_in = (p["q"], p["k"], p["v"], p["o"], p["do"], p["lse"])
    return {"fwd": lambda i: run("fwd", p["q"], p["k"], p["v"], p["o2"],
                                 p["l2"], B, H, H, Sq, Sk, D),
            "dq": lambda i: run("dq", *bwd_in, p["dq2"], B * H, Sq, Sk, D),
            "dkv": lambda i: run("dkv", *bwd_in, p["dk2"], p["dv2"], B * H,
                                 Sq, Sk, D)}


def f32_inputs(gen, dev, B, H, Sq, Sk, D, causal):
    """Seeded f32 inputs, this tree's forward O and LSE, the delta of this
    tree's dQ kernel, and output buffers."""
    fa = cs._flash_module()
    q, do = (torch.randn((B, H, Sq, D), generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev)
            for _ in range(2))
    with cs._counts_kept(fa):
        o, lse = fa._flash_forward(q, k, v, causal)
        delta = fa._launch_dq(q, k, v, o, lse, do, causal, D ** -0.5)[1]
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse,
            "delta": delta, "causal": causal, "o2": torch.empty_like(q),
            "l2": torch.empty_like(lse), "dq2": torch.empty_like(q),
            "delta2": torch.empty_like(lse), "dk2": torch.empty_like(k),
            "dv2": torch.empty_like(v)}


def f32_check(name, run, t, ref, dq64, ref_fwd):
    """One design's forward (O per row within O_ROW_TOL and LSE within
    LSE_TOL of ``ref_fwd``, the plain version's), dQ (against the float64
    formula and the f32 plain one; its delta, where it writes one, against
    rowsum(dO * O)) and dK/dV (against the f32 plain backward), per row
    within GRAD_ROW_TOL."""
    tol = cs.GRAD_ROW_TOL[torch.float32]
    t["delta2"].fill_(float("nan"))
    t["o2"].fill_(float("nan"))
    run["fwd"](0)
    run["dq"](0)
    run["dkv"](0)
    torch.cuda.synchronize()
    _, err_o_row, err_lse = cs.compare(t["o2"], t["l2"], *ref_fwd)
    fwd_ok = (err_o_row <= cs.O_ROW_TOL[torch.float32] and err_lse <= 1.0
              and bool(torch.isfinite(t["o2"]).all()))
    got = {"o_row": err_o_row, "lse_of_limit": err_lse,
           "dq_vs_f64": cs.grad_row_error(t["dq2"], dq64),
           "dq": cs.grad_row_error(t["dq2"], ref[0]),
           "dk": cs.grad_row_error(t["dk2"], ref[1]),
           "dv": cs.grad_row_error(t["dv2"], ref[2])}
    if name != "old":
        got["delta_of_limit"] = testing.delta_error(t["delta2"], t["do"],
                                                    t["o"])
    D = t["q"].shape[-1]
    emit({"check": f"{name} vs plain", "D": D, "causal": t["causal"],
          "shape": list(t["q"].shape), "err_row": got, "tol_row": tol})
    if not (fwd_ok and max(got[k] for k in ("dq_vs_f64", "dk", "dv")) <= tol
            and got.get("delta_of_limit", 0.0) <= 1.0):
        raise AssertionError(f"{name} at D={D}: disagrees with plain {got}")


def f32_bits(runs, t, names):
    """The designs' O, LSE, dQ, delta, dK and dV on the same inputs, bit
    for bit."""
    outs = {}
    for n in names:
        for kind in ("fwd", "dq", "dkv"):
            runs[n][kind](0)
        torch.cuda.synchronize()
        outs[n] = [t[x].clone() for x in ("o2", "l2", "dq2", "delta2",
                                          "dk2", "dv2")]
    same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
    emit({"check": f"{' vs '.join(names)}, bit for bit",
          "shape": list(t["q"].shape), "causal": t["causal"],
          "same": same})
    if not same:
        raise AssertionError(f"{names} differ at {list(t['q'].shape)}")


def f32_main(args, dev, gen):
    """--f32: the f32 forward and backward pairs at B=4, H=8, S=2048,
    causal, D in F32_DIMS: flash_attention_fwd.cu's forward and
    flash_attention_bwd.cu's pair (``old``), the wide instances through
    their C entry points (``wide``), this tree's tiled instances
    (``tree``) and F32_TILED_VARIANTS, each held against plain and timed
    in turns beside SDPA and the bound; with ``--parent``, the parent's
    and this tree's wide instances bit for bit above 256 and timed at
    D=512. Then the CUDA-core wide kernels (bf16) at WIDE_CC_DIMS."""
    fa = cs._flash_module()
    # The libraries this mode loads through the wrapper, built together.
    _build.build_all(("flash_attention_fwd", "flash_attention_bwd",
                      "flash_attention_wide", F32_LIB))
    variants = [n for n in (args.variants if args.variants is not None
                            else ",".join(F32_TILED_VARIANTS)).split(",")
                if n]
    names = ["tree", *variants] + (["parent"] if args.parent else [])
    libs = {n: lib[F32_LIB] for n, lib in build(names, args.parent,
                                                 (F32_LIB,)).items()}
    if args.parent:
        for D, shape in ((264, (2, 2, 200, 200)), (1032, (2, 2, 77, 131)),
                         (512, (B, H, S, S))):
            for causal in (True, False):
                if D == 512 and not causal:
                    continue
                t = f32_inputs(gen, dev, *shape[:2], *shape[2:], D, causal)
                runs = {n: f32_calls(n, libs[n], "_wide_f32", t)
                        for n in ("parent", "tree")}
                f32_bits(runs, t, ("parent", "tree"))
        for kind in ("fwd", "dq", "dkv"):
            ms = {"parent": [], "tree": []}
            for n in ("parent", "tree", "tree", "parent"):
                ms[n].append(cs.graph_ms(runs[n][kind], **F32_TIMING))
            emit({"timing": f"{kind}_wide_f32", "D": 512, "dtype": "float32",
                  "shape": [B, H, S, 512], "causal": True, "ms": ms})
    for D in F32_DIMS:
        t = f32_inputs(gen, dev, B, H, S, S, D, True)
        here = [n for n in variants if D in F32_VARIANT_SCOPE[n][0]]
        runs = {"old": old_calls(t),
                "wide": f32_calls("wide", libs["tree"], "_wide_f32", t),
                **{n: f32_calls(n, libs[n], "_tiled_f32", t)
                   for n in ["tree", *here]}}
        ref = fa._dense_backward(t["q"], t["k"], t["v"], t["o"], t["lse"],
                                 t["do"], True, D ** -0.5)
        dq64 = testing.dense_dq_f64(t["q"], t["k"], t["v"], t["o"],
                                    t["lse"], t["do"], True, D ** -0.5)
        ref_fwd = fa._dense_kernel(t["q"], t["k"], t["v"], True, D ** -0.5)
        for n, run in runs.items():
            f32_check(n, run, t, ref, dq64, ref_fwd)
        del ref, dq64, ref_fwd
        torch.cuda.empty_cache()
        for kind in ("fwd", "dq", "dkv"):
            others = ["old", "wide", *[n for n in here
                                       if kind in F32_VARIANT_SCOPE[n][1]]]
            order = [*others, "tree", "tree", *others[::-1]]
            ms = {n: [] for n in ["tree", *others]}
            for n in order:
                ms[n].append(cs.graph_ms(runs[n][kind], **F32_TIMING))
            bound_ms, bound_by = (
                cs.attention_bound(B, H, H, S, D, torch.float32, True)
                if kind == "fwd" else
                cs.backward_bound(B, H, S, D, torch.float32, True, kind))
            emit({"timing": kind, "D": D, "dtype": "float32",
                  "shape": [B, H, S, D], "causal": True, "ms": ms,
                  "bound_ms": bound_ms, "bound_by": bound_by})
        emit({"timing": "sdpa", "D": D, "dtype": "float32",
              "shape": [B, H, S, D], "causal": True,
              "sdpa_backend": cs._sdpa_backend(t["q"], t["k"], t["v"]),
              "forward_ms": cs.graph_ms(
                  lambda i: cs.F.scaled_dot_product_attention(
                      t["q"], t["k"], t["v"], is_causal=True),
                  **F32_TIMING),
              "backward_ms": cs._sdpa_backward_ms(t["q"], t["k"], t["v"],
                                                  t["do"])})
        del t, runs
        torch.cuda.empty_cache()
    for D in WIDE_CC_DIMS:
        wide_cuda_core(fa, gen, dev, D)


def wide_cuda_core(fa, gen, dev, D):
    """The CUDA-core wide forward, dQ and dK/dV (flash_attention_wide.cu,
    the rule's kernels for bf16/f16 above 1024) at B, H, S and head_dim D,
    causal, bf16, through their C entry points: held against the plain
    versions and timed through CUDA graphs of one call (each call takes
    hundreds of ms), beside SDPA (its backend named) and the bound."""
    dtype = torch.bfloat16
    scale = D ** -0.5
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    o, lse = cs._simt_forward(fa, q, k, v, True, wide=True)
    dq, = cs._simt_backward(fa, "dq", q, k, v, o, lse, do, True, wide=True)
    dk, dv = cs._simt_backward(fa, "dkv", q, k, v, o, lse, do, True,
                               wide=True)
    ro, rlse = fa._dense_kernel(q, k, v, True, scale)
    _, err_o_row, err_lse = cs.compare(o, lse, ro, rlse)
    del ro, rlse
    ref = fa._dense_backward(q, k, v, o, lse, do, True, scale)
    err = {n: cs.grad_row_error(g, r)
           for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
    del ref
    torch.cuda.empty_cache()
    ok = (err_o_row <= cs.O_ROW_TOL[dtype] and err_lse <= 1.0
          and max(err.values()) <= cs.GRAD_ROW_TOL[dtype])
    emit({"check": "wide vs plain", "D": D, "dtype": "bfloat16",
          "err_o_row": err_o_row, "err_lse_of_limit": err_lse,
          "err_row": err, "ok": ok})
    if not ok:
        raise AssertionError(f"the wide kernels at D={D} disagree with "
                             f"plain")
    one = {"iters": 1, "replays": 2}
    ms = {"fwd": cs.graph_ms(lambda i: cs._simt_forward(
              fa, q, k, v, True, wide=True), **one)}
    for kind in ("dq", "dkv"):
        ms[kind] = cs.graph_ms(lambda i, kind=kind: cs._simt_backward(
            fa, kind, q, k, v, o, lse, do, True, wide=True), **one)
    bound = {"fwd": cs.attention_bound(B, H, H, S, D, dtype, True),
             **{kind: cs.backward_bound(B, H, S, D, dtype, True, kind)
                for kind in ("dq", "dkv")}}
    backend = cs._sdpa_backend(q, k, v)
    try:
        sdpa = {"fwd": cs.graph_ms(lambda i: cs.F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), iters=2, replays=3),
                "bwd": cs._sdpa_backward_ms(q, k, v, do, iters=2,
                                            replays=3)}
    except RuntimeError as e:   # no backend took the shape
        sdpa, backend = None, f"none took the shape: {str(e)[:160]}"
    emit({"timing": "wide", "D": D, "dtype": "bfloat16",
          "shape": [B, H, S, D], "causal": True, "ms": ms, "bound": bound,
          "sdpa_ms": sdpa, "sdpa_backend": backend})


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout (git archive) of the "
                    "commit to compare with")
    ap.add_argument("--variants", default=None,
                    help="comma-separated textual variants to build "
                         "(default: all of the mode's)")
    ap.add_argument("--wide", action="store_true",
                    help="the tensor-core wide kernels (head_dim above "
                         "256) and WIDE_VARIANTS")
    ap.add_argument("--wide-f32", action="store_true",
                    help="the f32 wide kernels (head_dim above 256) and "
                         "WIDE_F32_VARIANTS")
    ap.add_argument("--f32", action="store_true",
                    help="the f32 forward and backward pairs at head_dim "
                         "up to 256 and F32_TILED_VARIANTS, then the "
                         "CUDA-core wide kernels at WIDE_CC_DIMS")
    args = ap.parse_args()
    if args.f32:
        dev = torch.device("cuda", 0)
        f32_main(args, dev, torch.Generator(device=dev).manual_seed(cs.SEED))
        print(cs.card_line(), flush=True)
        return 0
    if args.wide_f32 and args.parent:
        ap.error("--parent does not apply to --wide-f32")
    tc_wide = args.wide and not args.wide_f32
    args.wide = args.wide or args.wide_f32
    fa = cs._flash_module()
    dtype = torch.float32 if args.wide_f32 else torch.bfloat16
    default = (WIDE_F32_VARIANTS if args.wide_f32 else WIDE_VARIANTS
               if args.wide else VARIANTS)
    variants = [n for n in (args.variants if args.variants is not None
                            else ",".join(default)).split(",") if n]
    names = ["tree", *variants] + (["parent"] if args.parent else [])
    libs = build(names, args.parent, ("flash_attention_wide_f32",)
                 if args.wide_f32 else ("flash_attention_wide_wgmma",)
                 if args.wide else LIBS)
    fns = {n: entry_points(n, libs[n]) for n in names}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    if args.parent:
        if tc_wide:
            wide_same_bits(fns, libs, gen, dev)
        else:
            digests(fns, dev)

    def in_scope(n, D):
        if n == "parent":
            return not tc_wide or D <= 1024   # the parent held Q
        if n in WIDE_VARIANT_SCOPE:
            return D in WIDE_VARIANT_SCOPE[n][0]
        return args.wide or D in VARIANT_DIMS.get(n, DIMS)

    def timed(fn, n, D):
        if n == "cuda_core":
            return cs.cuda_ms(lambda: fn(0), iters=1, warmup=0)
        return cs.graph_ms(fn, **(WIDE_HEAVY_TIMING if D >= 1024 else {}))

    dims = WIDE_F32_DIMS if args.wide_f32 else WIDE_DIMS if args.wide \
        else DIMS
    for D in dims:
        t = wide_inputs(gen, dev, dtype, B, H, S, S, D, True)
        others = [n for n in names if n != "tree" and in_scope(n, D)]
        runs = {n: calls(n, fns[n], t, _takes_work(n, libs[n]))
                for n in ["tree", *others]}
        if tc_wide and D > 1024:
            runs["cuda_core"] = cuda_core_calls(t)
            others.append("cuda_core")
        if "parent" in others and not tc_wide:
            same_bits(runs, t, D)
        runs["tree"]["fwd"](0)
        torch.cuda.synchronize()
        to, tlse = t["o2"].clone(), t["l2"].clone()
        ro, rlse = fa._dense_kernel(t["q"], t["k"], t["v"], True, D ** -0.5)
        _, err_row, err_lse = cs.compare(to, tlse, ro, rlse)
        emit({"check": "tree vs plain", "D": D, "err_o_row": err_row,
              "tol_o_row": cs.O_ROW_TOL[dtype],
              "err_lse_of_limit": err_lse})
        if args.wide:
            dq_check(runs, others, t, D)
            dkv_check(runs, others, t, D)
        for n in others:
            runs[n]["fwd"](0)
            torch.cuda.synchronize()
            # The CUDA-core kernels against the plain version, the rest against
            # this tree's.
            against = "plain" if n == "cuda_core" else "tree"
            _, err_row, err_lse = cs.compare(
                t["o2"], t["l2"], *((ro, rlse) if n == "cuda_core"
                                    else (to, tlse)))
            emit({"check": f"{n} vs {against}", "D": D,
                  "err_o_row": err_row, "tol_o_row": cs.O_ROW_TOL[dtype],
                  "err_lse_of_limit": err_lse,
                  "same_bits": torch.equal(t["o2"], to)
                  and torch.equal(t["l2"], tlse)})
            if not (err_row <= cs.O_ROW_TOL[dtype] and err_lse <= 1.0):
                raise AssertionError(f"{n} at D={D} disagrees with "
                                     f"{against}")
        del ro, rlse
        torch.cuda.empty_cache()
        for kind in ("fwd", "dq", "dkv"):
            with_kind = [n for n in others if kind in kinds(n)]
            order = [*with_kind, "tree", "tree", *with_kind[::-1]]
            ms = {n: [] for n in ["tree", *with_kind]}
            for n in order:
                ms[n].append(timed(runs[n][kind], n, D))
            bound_ms, bound_by = (
                cs.attention_bound(B, H, H, S, D, dtype, True)
                if kind == "fwd" else
                cs.backward_bound(B, H, S, D, dtype, True, kind))
            line = {"timing": kind, "D": D, "dtype": cs._dtype_name(dtype),
                    "shape": [B, H, S, D], "causal": True, "ms": ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
            if tc_wide:
                # This tree's TMA copies, and their rate at its best time.
                nbytes = wide_tma_bytes(kind, B, H, S, D)
                line.update(tma_gb=nbytes / 1e9,
                            tma_tb_per_s=nbytes / min(ms["tree"]) / 1e9)
            emit(line)
        del t, runs
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
