"""Twins of the reference's ``TransformersTrainer`` tests
(``tests/test_train_huggingface.py``) on the CPU, at its tiny BERT config
(``:26-33``): a Flax ``FlaxBertForSequenceClassification`` from seed 0
beside the PyTorch ``BertForSequenceClassification`` that carries the same
weights through ``bert_state_dict_from_flax``.

- The converted weights give the Flax model's logits, with padding in the
  attention mask, to rtol 1e-5 (f32: the same operations in another
  framework; the worst element seen is about 1e-6 relative).
- Four steps of the port's step (loss, gradients, the default AdamW)
  follow the reference's ``jax.value_and_grad`` with ``optax.adamw`` on
  the same batches: the losses to rtol 1e-5, every parameter to rtol
  1e-4 with atol 1e-7 for elements near zero (without it one word
  embedding of 2048, about 7e-6, fails by 1.5e-9 absolute).
- Both branches of ``_default_loss`` against the reference's, to rtol
  1e-6.
- A fresh interpreter that imports ``ray_tpu_torch.train.huggingface``
  and runs one CPU step through ``TransformersTrainer`` loads no JAX,
  flax or optax.

The whole trainer on both sides, with the same data, is slow-marked as
the reference's tests are. The Flax model is built once per module (the
``transformers`` import with Flax takes tens of seconds).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as td
from ray_tpu_torch.train import huggingface as thf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_labels=2)
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-7
LOSS_FN_RTOL = 1e-6


@pytest.fixture(scope="module")
def flax_bert():
    """(Flax model, its parameters as numpy, the transformers module)."""
    import jax
    import transformers

    model = transformers.FlaxBertForSequenceClassification(
        transformers.BertConfig(**TINY), seed=0)
    return model, jax.tree_util.tree_map(np.asarray, model.params), \
        transformers


def _torch_bert(flax_bert):
    _, params, transformers = flax_bert
    model = transformers.BertForSequenceClassification(
        transformers.BertConfig(**TINY))
    model.load_state_dict(thf.bert_state_dict_from_flax(params),
                          strict=True)
    return model.eval()


def _toy_columns(n=128, seq=8):
    """The reference test's separable toy task (label 1 iff token 3 at
    position 0), int32 as there."""
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 64, size=(n, seq)).astype(np.int32)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    ids[labels == 1, 0] = 3
    return {"input_ids": ids, "attention_mask": np.ones((n, seq), np.int32),
            "labels": labels}


def test_state_dict_from_flax_gives_flax_logits(flax_bert):
    model, _, _ = flax_bert
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, size=(6, 16)).astype(np.int32)
    mask = np.ones((6, 16), np.int32)
    mask[:, 12:] = 0      # right padding
    mask[1, 5:] = 0
    mask[4, 1:] = 0       # only [CLS] attended
    want = np.asarray(model(input_ids=ids, attention_mask=mask).logits)
    with torch.no_grad():
        got = _torch_bert(flax_bert)(
            input_ids=torch.as_tensor(ids),
            attention_mask=torch.as_tensor(mask)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=0)


def test_adamw_steps_follow_optax(flax_bert):
    import jax
    import optax

    model, params, _ = flax_bert
    cols = _toy_columns(n=4 * 32)
    batches = [{k: v[i * 32:(i + 1) * 32] for k, v in cols.items()}
               for i in range(4)]
    opt = optax.adamw(5e-5)

    @jax.jit
    def local_grads(p, batch):
        labels = batch["labels"]
        inputs = {k: v for k, v in batch.items() if k != "labels"}

        def closs(p):
            return jnp_loss(model(**inputs, params=p).logits, labels)

        return jax.value_and_grad(closs)(p)

    from ray_tpu.train.huggingface import _default_loss as jnp_loss

    p, state = params, opt.init(params)
    want_losses = []
    for b in batches:
        loss, grads = local_grads(p, b)
        updates, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))

    tm = _torch_bert(flax_bert)
    tparams = [q for q in tm.parameters() if q.requires_grad]
    topt = thf.default_optimizer()(tparams)
    got_losses = [float(thf._train_step(tm, topt, thf._default_loss, b,
                                        torch.device("cpu")))
                  for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    want = thf.bert_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, p))
    got = tm.state_dict()
    assert set(want) <= set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["classification", "regression",
                                  "one_column_head"])
def test_default_loss_matches_reference(case):
    import jax.numpy as jnp

    from ray_tpu.train.huggingface import _default_loss as ref_loss

    rng = np.random.default_rng(2)
    if case == "classification":
        logits = rng.standard_normal((8, 3)).astype(np.float32)
        labels = rng.integers(0, 3, 8).astype(np.int32)
    elif case == "regression":
        logits = rng.standard_normal((8, 1)).astype(np.float32)
        labels = rng.standard_normal((8, 1)).astype(np.float32)
    else:   # [B, 1] logits with [B] labels: the cross-entropy branch
        logits = rng.standard_normal((8, 1)).astype(np.float32)
        labels = np.zeros(8, np.int32)
    want = float(ref_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(thf._default_loss(torch.as_tensor(logits),
                                  torch.as_tensor(labels)))
    np.testing.assert_allclose(got, want, rtol=LOSS_FN_RTOL)


_NO_JAX_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.train import huggingface

    def model_init():
        import torch
        from transformers import BertConfig, BertForSequenceClassification
        torch.manual_seed(0)
        return BertForSequenceClassification(BertConfig(**%r))

    rng = np.random.default_rng(0)
    cols = {"input_ids": rng.integers(4, 64, (8, 8)).astype(np.int32),
            "attention_mask": np.ones((8, 8), np.int32),
            "labels": rng.integers(0, 2, 8).astype(np.int32)}
    rt.init(num_cpus=2)
    try:
        res = huggingface.TransformersTrainer(
            model_init=model_init, batch_size=8, report_every=1,
            device="cpu", datasets={"train": data.from_columns(cols)}).fit()
    finally:
        rt.shutdown()
    print(json.dumps({
        "steps": [h["step"] for h in res.metrics_history],
        "loss": res.metrics_history[-1]["loss"],
        "transformers": "transformers" in sys.modules,
        "loaded": sorted(m for m in ("jax", "flax", "optax")
                         if m in sys.modules)}))
""") % (TINY,)


def test_port_module_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("USE_TORCH", "USE_TF", "USE_FLAX")}
    env["PYTHONPATH"] = REPO
    env["HOME"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _NO_JAX_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["steps"] == [1, 1]     # one report a step, then "done"
    assert np.isfinite(got["loss"])
    assert got["transformers"] and got["loaded"] == []


# ------------------------------------------------------------ slow twins
@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _fit_both(flax_bert, n=128, **kw):
    from ray_tpu.train import TransformersTrainer as JTrainer

    model, params, transformers = flax_bert
    sd = thf.bert_state_dict_from_flax(params)

    def torch_init():
        m = transformers.BertForSequenceClassification(
            transformers.BertConfig(**TINY))
        m.load_state_dict(sd, strict=True)
        return m

    ref = JTrainer(model_init=lambda: model,
                   datasets={"train": jd.from_columns(_toy_columns(n),
                                                      parallelism=2)},
                   **kw).fit()
    port = thf.TransformersTrainer(
        model_init=torch_init, device="cpu",
        datasets={"train": td.from_columns(_toy_columns(n),
                                           parallelism=2)}, **kw).fit()
    return ref, port


@pytest.mark.slow
def test_trainer_learns_like_reference(flax_bert, runtimes, tmp_path):
    from ray_tpu_torch.train import (
        CSVLoggerCallback,
        JsonLoggerCallback,
        RunConfig,
    )

    ref, port = _fit_both(flax_bert, num_epochs=4, batch_size=32,
                          report_every=1)
    hist = [h for h in port.metrics_history if "loss" in h]
    ref_hist = [h for h in ref.metrics_history if "loss" in h]
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    assert len(hist) >= 4 and hist[-1]["loss"] < hist[0]["loss"]
    np.testing.assert_allclose(hist[0]["loss"], ref_hist[0]["loss"],
                               rtol=LOSS_RTOL)
    # The logger callbacks write the result stream.
    port2 = thf.TransformersTrainer(
        model_init=lambda: _torch_bert(flax_bert), device="cpu",
        num_epochs=1, batch_size=32, report_every=1,
        run_config=RunConfig(callbacks=[JsonLoggerCallback(str(tmp_path)),
                                        CSVLoggerCallback(str(tmp_path))]),
        datasets={"train": td.from_columns(_toy_columns(), parallelism=2)}
    ).fit()
    lines = open(os.path.join(tmp_path, "result.json")).read().splitlines()
    assert len(lines) == len(port2.metrics_history)
    assert "loss" in json.loads(lines[0])
    assert "loss" in open(os.path.join(tmp_path, "progress.csv")).readline()


@pytest.mark.slow
@pytest.mark.parametrize("n", [128, 97], ids=["even", "uneven"])
def test_trainer_data_parallel_like_reference(flax_bert, runtimes, n):
    from ray_tpu.train import ScalingConfig as JScaling
    from ray_tpu.train import TransformersTrainer as JTrainer
    from ray_tpu_torch.train import ScalingConfig

    model, params, transformers = flax_bert
    ref = JTrainer(model_init=lambda: model, num_epochs=1, batch_size=32,
                   report_every=1, scaling_config=JScaling(num_workers=2),
                   datasets={"train": jd.from_columns(_toy_columns(n),
                                                      parallelism=2)}).fit()
    port = thf.TransformersTrainer(
        model_init=lambda: _torch_bert(flax_bert), device="cpu",
        num_epochs=1, batch_size=32, report_every=1,
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": td.from_columns(_toy_columns(n),
                                           parallelism=2)}).fit()
    for res in (ref, port):
        assert {h.get("rank") for h in res.metrics_history} == {0}
        assert all(np.isfinite(h["loss"]) for h in res.metrics_history)
    assert [h["step"] for h in port.metrics_history] == [
        h["step"] for h in ref.metrics_history]
    np.testing.assert_allclose(
        [h["loss"] for h in port.metrics_history],
        [h["loss"] for h in ref.metrics_history], rtol=LOSS_RTOL)
