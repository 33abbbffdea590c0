#!/usr/bin/env python
"""How far a tp sum across processes moves the flagship's step from one
process's, on the CPU.

Four gloo worker processes (``torch_distributed_worker.py``) of one CPU
shard each train ``make_mesh(tp=4)``; one process trains the same mesh
over four CPU shards. Both take ``--steps`` steps of AdamW (lr 3e-4, the
step's default) and then, from the same initial weights, two of SGD (lr
0.1), on the same batches. The four processes add each row-parallel sum
in another order than the one process's fold, which is what
``chip_smoke.py`` phase 23 (f)'s ``tp4x1`` does over NCCL. Prints, per
optimizer, the largest relative loss difference, the largest leaf
difference and how many leaf elements differ by more than 1e-7, 1e-6,
1e-5 and 1e-4, as one JSON line.

Usage:
    python scripts/tp_reorder_rehearsal.py [--d-model 256] [--layers 4]
        [--vocab 4096] [--seq 256] [--batch 4] [--steps 6]

Keep it small: every process holds the whole model on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_distributed_worker as worker  # noqa: E402
from ray_tpu_torch.models import (  # noqa: E402
    TransformerConfig,
    init_params,
    make_spmd_train_step,
)
from ray_tpu_torch.parallel import MeshConfig, make_mesh  # noqa: E402

TP = 4


def _optimizer(name, lr):
    if name == "sgd":
        return lambda ls: torch.optim.SGD(ls, lr=lr)
    return lambda ls: torch.optim.AdamW(ls, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=1e-4)


def compare(cfg, tokens, name, lr, steps, tmp):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    job = {"kind": "step", "name": name, "cfg": fields, "mesh": {"tp": TP},
           "optimizer": name, "lr": lr, "steps": steps, "init_seed": 0,
           "microbatches": 1}
    os.makedirs(tmp)
    outs = worker.launch([job], tmp, processes=TP, backend="gloo",
                         devices=["cpu"],
                         arrays={"tokens": tokens[:, :, :-1],
                                 "targets": tokens[:, :, 1:]},
                         timeout_s=1200.0)
    mesh = make_mesh(MeshConfig(tp=TP), devices=[torch.device("cpu")] * TP)
    step, _, shards = make_spmd_train_step(
        cfg, mesh, init_params(cfg, 0, device="cpu"),
        optimizer=_optimizer(name, lr))
    want = [step(torch.from_numpy(tokens[i, :, :-1]),
                 torch.from_numpy(tokens[i, :, 1:])).item()
            for i in range(steps)]
    loss_err = max(abs(g - w) / abs(w) for out in outs
                   for g, w in zip(out[f"{name}/losses"], want))
    leaf_err, beyond, total = 0.0, [0, 0, 0, 0], 0
    for j, tree in enumerate(shards):
        for path, leaf in worker._flat(tree):
            d = np.abs(outs[j][f"{name}/{j}/{path}"]
                       - leaf.detach().numpy())
            leaf_err = max(leaf_err, float(d.max()))
            total += d.size
            beyond = [b + int((d > t).sum()) for b, t in
                      zip(beyond, (1e-7, 1e-6, 1e-5, 1e-4))]
    return {"optimizer": name, "steps": steps, "loss_err": loss_err,
            "leaf_err": leaf_err,
            "elements_beyond_1e-7_1e-6_1e-5_1e-4": beyond,
            "elements": total}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    d = args.d_model
    cfg = TransformerConfig(vocab_size=args.vocab, d_model=d,
                            n_layers=args.layers, n_heads=8, n_kv_heads=8,
                            d_ff=d * 43 // 16, max_seq_len=args.seq,
                            dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size,
                          (args.steps, args.batch, args.seq + 1))
    with tempfile.TemporaryDirectory() as tmp:
        for name, lr, steps in (("adamw", 3e-4, args.steps),
                                ("sgd", 0.1, 2)):
            print(json.dumps({"d_model": d, "layers": args.layers,
                              "vocab": args.vocab, "seq": args.seq,
                              "batch": args.batch,
                              **compare(cfg, tokens, name, lr, steps,
                                        os.path.join(tmp, name))}),
                  flush=True)


if __name__ == "__main__":
    main()
