"""The port's checkpoints (``ray_tpu_torch.train.checkpoint``) on the CPU:
the flat form's leaf order against ``jax.tree.flatten`` (which orders the
reference's ``leaves.npz``), round trips, and the flagship train step
resumed from a checkpoint.

No test calls the reference's ``save_pytree``: it tries orbax first, and
orbax starts threads. Every comparison here is exact (bit for bit): a
checkpoint stores the bytes it was given, and a resumed step runs the
same operations on the same values as an uninterrupted one.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch import models as tm
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

CPU = "cpu"


def _tree():
    """Every leaf kind, in containers whose dict keys are out of order,
    with None between leaves and leaves of distinct values."""
    g = torch.Generator().manual_seed(0)
    return {
        "z": torch.randn(3, 5, generator=g),
        "a": [torch.randn(4, generator=g).to(torch.bfloat16), None,
              (np.arange(6, dtype=np.int32).reshape(2, 3), 7, 2.5)],
        "m": {"y": torch.arange(5) * 3, "b": np.float64(-1.25),
              "c": (None, True, torch.tensor(9.0, dtype=torch.float16))},
        "e": torch.randn(2, 3, generator=g).T,   # not contiguous
    }


def _bits(x):
    """A leaf as a numpy array of its exact bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    else:
        assert got == want


def test_leaf_order_is_jax_tree_flatten(tmp_path):
    tree = _tree()
    tckpt.save_pytree(tree, str(tmp_path))
    want = jax.tree.flatten(tree)[0]
    with np.load(tmp_path / "leaves.npz") as data:
        assert sorted(data.files, key=int) == [str(i) for i in
                                               range(len(want))]
        for i, leaf in enumerate(want):
            assert np.array_equal(data[str(i)], _bits(leaf)), i


def test_round_trip_is_bit_for_bit(tmp_path):
    tree = _tree()
    # bf16 values that a careless conversion would change: -0.0, a
    # subnormal, inf, a NaN with a payload, the largest finite.
    special = torch.from_numpy(np.array(
        [0x8000, 0x0001, 0x7F80, 0x7FC1, 0x7F7F], np.uint16).view(
        np.int16)).view(torch.bfloat16)
    tree["special"] = special
    tckpt.save_pytree(tree, str(tmp_path))
    back = tckpt.load_pytree(str(tmp_path), device=CPU)
    _assert_same(back, tree)
    assert np.array_equal(_bits(back["special"]), _bits(special))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64, torch.bool,
                                   torch.uint8])
def test_round_trip_of_each_dtype(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    t = (torch.randn(4, 6, generator=g) * 100).to(dtype)
    tree = [t, (t[0, 0].clone(), [t[:, ::2]])]
    tckpt.save_pytree(tree, str(tmp_path))
    _assert_same(tckpt.load_pytree(str(tmp_path), device=CPU), tree)


@pytest.mark.parametrize("leaf", ["text", b"bytes", object(),
                                  {1: 2}.keys()])
def test_unsupported_leaves_raise(tmp_path, leaf):
    with pytest.raises(TypeError, match="cannot save"):
        tckpt.save_pytree({"x": leaf}, str(tmp_path))


def test_checkpoint_directory_api(tmp_path):
    data = {"epoch": 3, "metrics": [0.5, 0.25]}
    ck = ttrain.Checkpoint.from_dict(data)
    assert ck.to_dict() == data
    moved = ck.copy_to(str(tmp_path / "copy"))
    assert moved.to_dict() == data and moved.path != ck.path
    assert ttrain.Checkpoint.from_directory(
        moved.as_directory()).to_dict() == data
    tree = _tree()
    ck = ttrain.Checkpoint.from_pytree(tree, str(tmp_path / "tree"))
    assert ck.as_directory() == str(tmp_path / "tree")
    _assert_same(ck.to_pytree(device=CPU), tree)
    with open(tmp_path / "tree" / "pytree" / "structure.pkl", "rb") as f:
        assert pickle.load(f)["a"][1] is None
    assert repr(ck) == f"Checkpoint({tmp_path / 'tree'})"


def test_storage_uris_wait_for_the_runtime(tmp_path):
    ck = ttrain.Checkpoint.from_dict({"a": 1})
    with pytest.raises(NotImplementedError, match="A.5"):
        ck.to_uri("memory://ckpt")
    with pytest.raises(NotImplementedError, match="A.5"):
        ttrain.Checkpoint.from_uri("memory://ckpt")


def test_load_defaults_to_the_card_and_refuses_to_fall_back(
        tmp_path, monkeypatch):
    tckpt.save_pytree({"x": torch.ones(2)}, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.load_pytree(str(tmp_path))


# ------------------------------------------------- the flagship, resumed

TINY = tm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=2, n_kv_heads=2, d_ff=48)
B, S = 2, 16


def _batch():
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, TINY.vocab_size, (B, S + 1)))
    return tokens[:, :-1], tokens[:, 1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_resumes_bit_for_bit(tmp_path, dtype):
    """4 uninterrupted AdamW steps, against 2 steps, a checkpoint of the
    parameters and the optimizer's state, a fresh step built from other
    weights with both restored, and 2 more steps."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    inputs, targets = _batch()
    params = tm.init_params(cfg, 0, device=CPU)
    step = tm.make_train_step(cfg, params)
    want = [step(inputs, targets).item() for _ in range(4)]

    first = tm.init_params(cfg, 0, device=CPU)
    step = tm.make_train_step(cfg, first)
    got = [step(inputs, targets).item() for _ in range(2)]
    ck = ttrain.Checkpoint.from_pytree(
        {"params": first, "opt": step.optimizer.state_dict()},
        str(tmp_path / "ck"))
    fresh = tm.init_params(cfg, 1, device=CPU)
    assert not torch.equal(fresh["embed"], first["embed"])
    del first, step
    restored = ck.to_pytree(device=CPU)
    with torch.no_grad():
        _copy_tree(fresh, restored["params"])
    step = tm.make_train_step(cfg, fresh)
    step.optimizer.load_state_dict(restored["opt"])
    got += [step(inputs, targets).item() for _ in range(2)]
    assert got == want
    _assert_same(_detached(fresh), _detached(params))


def _copy_tree(dst, src):
    if isinstance(dst, dict):
        assert sorted(dst) == sorted(src)
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()
