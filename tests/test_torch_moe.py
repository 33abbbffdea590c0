"""Parity of the port's one-device MoE (the reference's dense fallback in
``_mlp_block``) with the JAX reference, on the CPU.

The configs are ``tests/test_transformer.py``'s ``MOE`` (4 experts, every
second layer MoE) and a ``moe_every=1`` variant, whose dense MLP leaves no
layer uses. Weights come from the reference's ``init_params`` through
``params_from_jax``; tokens from a numpy seed; both sides in f32 at the
limits of the dense twins (``tests/test_torch_train.py``,
``tests/test_torch_transformer.py``).

Top-1 routing can flip between the two frameworks on a near-tie of two
experts. Each test compares the routing decisions first and reports the
smallest top-two probability gap beside a mismatch, so a flip reads as a
flip and not as a tolerance failure.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm as jllm
import ray_tpu.models as jm
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
import ray_tpu_torch.llm as tllm
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5
LR = 3e-4
PARAM_ATOL = 1e-6
# Adam's first step moves an element by lr * g / (|g| + 1e-8). Where |g| is
# near that eps the step is ill-conditioned: a rarely chosen expert's
# gradient elements sit at ~1e-8, and an f32 summation difference of ~3e-10
# in them (far inside GRAD_REL of the leaf) moves the update by ~1e-6.
# Those elements (|g| below 100 eps) are held at lr / 10, which a sign
# error or a skipped update of a well-defined gradient still breaks.
ADAM_CONDITIONED_GRAD = 1e-6
NEAR_EPS_ATOL = LR / 10

MOE = jm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=64, num_experts=4, moe_every=2, capacity_factor=16.0,
    dtype=jnp.float32)
CONFIGS = {"moe_every2": MOE,
           "moe_every1": dataclasses.replace(MOE, moe_every=1)}
B, S = 2, 16


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = torch.float32
    return tt.TransformerConfig(**fields)


def _pair(cfg):
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(cfg), device="cpu")
    return jp, tp


@pytest.fixture(params=list(CONFIGS))
def model(request):
    cfg = CONFIGS[request.param]
    jp, tp = _pair(cfg)
    return cfg, _port_cfg(cfg), jp, tp


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _is_moe(cfg, i):
    return i % cfg.moe_every == cfg.moe_every - 1


def _reference_routes(cfg, jp, tokens):
    """Router probabilities [B*S, E] of each MoE layer of the reference's
    cacheless forward, replayed layer by layer with its own functions."""
    Bt, St = tokens.shape
    x = jp["embed"].astype(cfg.dtype)[jnp.asarray(tokens)]
    positions = jnp.broadcast_to(jnp.arange(St), (Bt, St))
    probs = []
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in jp["layers"].items()}
        h = jt.rms_norm(x, lp["attn_norm"])
        q, k, v = jt._project_qkv(cfg, lp, h, positions)
        o = jt._attention_dense(q, k, v)
        h = jt.rms_norm(x + o.reshape(Bt, St, -1) @ lp["wo"], lp["mlp_norm"])
        if _is_moe(cfg, i):
            logits = (h.astype(jnp.float32) @ lp["router"]).reshape(
                Bt * St, cfg.num_experts)
            probs.append(np.asarray(jax.nn.softmax(logits, axis=-1)))
        x = jt._layer_fn(cfg, lp, x, positions, i)
    return probs


def _port_routes(monkeypatch):
    """Records the router probabilities of every MoE layer the port runs."""
    seen = []
    route = tt._moe_route

    def recording(cfg, lp, h):
        probs, top = route(cfg, lp, h)
        seen.append(probs.detach().numpy().copy())
        return probs, top

    monkeypatch.setattr(tt, "_moe_route", recording)
    return seen


def _assert_same_routes(ref_probs, port_probs):
    assert len(port_probs) == len(ref_probs)
    for layer, (r, p) in enumerate(zip(ref_probs, port_probs)):
        top2 = np.sort(r, axis=-1)[:, -2:]
        gap = float((top2[:, 1] - top2[:, 0]).min())
        flips = np.nonzero(r.argmax(-1) != p.argmax(-1))[0]
        print(f"MoE layer {layer}: smallest top-two gap {gap:.3g}")
        assert flips.size == 0, (
            f"routing flip at MoE layer {layer}, tokens {flips.tolist()}; "
            f"smallest top-two gap {gap:.3g}")


def test_init_params_builds_moe_leaves_like_reference():
    for cfg in CONFIGS.values():
        jp = jm.init_params(cfg, jax.random.PRNGKey(0))
        tp = tm.init_params(_port_cfg(cfg), 3, device="cpu")
        assert set(tp["layers"]) == set(jp["layers"])
        for name, leaf in jp["layers"].items():
            assert tuple(tp["layers"][name].shape) == leaf.shape, name
        # Fan-in scales: router and e_gate by d_model, e_down by d_ff.
        for name, fan_in in (("router", cfg.d_model), ("e_gate", cfg.d_model),
                             ("e_down", cfg.d_ff)):
            std = float(tp["layers"][name].std())
            assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (name, std)
        assert not torch.equal(tp["layers"]["e_gate"], tp["layers"]["e_up"])


def test_forward_routes_and_logits_match_reference(model, monkeypatch):
    cfg, tcfg, jp, tp = model
    tokens = _batch(1, cfg.vocab_size)[0]
    seen = _port_routes(monkeypatch)
    out = tm.forward(tcfg, tp, torch.from_numpy(tokens))
    _assert_same_routes(_reference_routes(cfg, jp, tokens), seen)
    ref = jm.forward(cfg, jp, jnp.asarray(tokens))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL)


def _flat(jtree, ttree):
    out = [(n, np.asarray(jtree[n]), ttree[n])
           for n in ("embed", "final_norm", "lm_head")]
    out += [(f"layers.{n}", np.asarray(jtree["layers"][n]),
             ttree["layers"][n]) for n in sorted(ttree["layers"])]
    return out


def test_loss_and_grads_match_reference(model, monkeypatch):
    """Every gradient leaf, the MoE leaves and (at moe_every=1) the dense
    MLP leaves no layer uses, whose reference gradient is exactly zero and
    whose port gradient stays None under ``backward``."""
    cfg, tcfg, jp, tp = model
    tokens, targets = _batch(2, cfg.vocab_size)
    seen = _port_routes(monkeypatch)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jt.loss_fn(cfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets)))(jp)
    for t in tt._leaves(tp):
        t.requires_grad_(True)
    loss = tm.loss_fn(tcfg, tp, torch.from_numpy(tokens),
                      torch.from_numpy(targets))
    loss.backward()
    _assert_same_routes(_reference_routes(cfg, jp, tokens), seen)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    unused = []
    for name, ref, leaf in _flat(ref_grads, tp):
        if leaf.grad is None:
            unused.append(name)
            assert not ref.any(), name
            continue
        err = float(np.abs(ref - leaf.grad.numpy()).max()
                    / max(np.abs(ref).max(), 1e-30))
        assert err <= GRAD_REL, (name, err)
    want_unused = ([] if cfg.moe_every != 1 else
                   ["layers.w_down", "layers.w_gate", "layers.w_up"])
    assert unused == want_unused


def _spmd_step(cfg, jp, tokens, targets, lr):
    """One step of the reference's ``make_spmd_train_step`` on a
    one-device mesh: (params, loss, gradients)."""
    import optax

    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices("cpu")[:1])
    jstep, pspec, _ = jt.make_spmd_train_step(
        cfg, mesh, jp, optimizer=optax.adamw(lr))
    jparams = jt.shard_params_for_step(jp, mesh, pspec)
    opt_state = optax.adamw(lr).init(jparams)
    jparams, _, jloss = jstep(jparams, opt_state, jnp.asarray(tokens),
                              jnp.asarray(targets))
    grads = jax.grad(lambda p: jt.loss_fn(cfg, p, jnp.asarray(tokens),
                                          jnp.asarray(targets)))(jp)
    return jparams, jloss, grads


def test_train_step_matches_spmd_train_step_on_one_device(model):
    """One AdamW step against ``make_spmd_train_step`` on a one-device
    mesh, every element within PARAM_ATOL where Adam's step is
    well-conditioned (see NEAR_EPS_ATOL)."""
    cfg, tcfg, jp, tp = model
    tokens, targets = _batch(3, cfg.vocab_size)
    jparams, jloss, jgrads = _spmd_step(cfg, jp, tokens, targets, LR)
    step = tm.make_train_step(tcfg, tp, lr=LR)
    loss = step(torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    grads = {n: g for n, g, _ in _flat(jgrads, tp)}
    for name, ref, leaf in _flat(jparams, tp):
        err = np.abs(leaf.detach().numpy() - ref)
        conditioned = np.abs(grads[name]) >= ADAM_CONDITIONED_GRAD
        assert err[conditioned].max(initial=0) <= PARAM_ATOL, name
        assert err[~conditioned].max(initial=0) <= NEAR_EPS_ATOL, name


def test_unused_dense_leaves_decay_like_optax():
    """At moe_every=1 no layer uses the dense MLP leaves: optax gives
    them a zero gradient and decays them, so the port must too (a leaf
    whose gradient stays None is skipped by torch's AdamW, decay
    included). At lr 3e-4 the decay (lr * 1e-4 relative) is below an f32
    ulp, so this step takes lr 0.5. optax folds the decay into the update
    where torch scales the parameter first, so the two round apart by up
    to 2 ulps (2.4e-7 relative); a skipped decay reads 5e-5."""
    cfg = CONFIGS["moe_every1"]
    jp, tp = _pair(cfg)
    tokens, targets = _batch(4, cfg.vocab_size)
    jparams = _spmd_step(cfg, jp, tokens, targets, 0.5)[0]
    before = {n: tp["layers"][n].clone() for n in ("w_gate", "w_up",
                                                   "w_down")}
    tm.make_train_step(_port_cfg(cfg), tp, lr=0.5)(
        torch.from_numpy(tokens), torch.from_numpy(targets))
    for name, old in before.items():
        new = tp["layers"][name].detach()
        np.testing.assert_allclose(new.numpy(),
                                   np.asarray(jparams["layers"][name]),
                                   rtol=2.4e-7, atol=0, err_msg=name)
        torch.testing.assert_close(new, old * (1 - 0.5 * 1e-4), rtol=1e-7,
                                   atol=0)


def test_prefill_decode_and_verify_match_reference(model, monkeypatch):
    """prefill_with_cache, five greedy decode_steps and one verify_step
    of C=4 against the reference: routing of the prefill, logits, tokens
    and cache contents."""
    cfg, tcfg, jp, tp = model
    prompt = [3, 17, 5, 9, 22, 40, 1]
    table = np.zeros((1, 5), np.int32)
    table[0, :4] = [7, 2, 11, 4]
    toks = np.zeros((1, 8), np.int32)
    toks[0, :len(prompt)] = prompt
    jcache = jm.init_kv_cache(cfg, 16, 4)
    tcache = tm.init_kv_cache(tcfg, 16, 4, device="cpu")
    seen = _port_routes(monkeypatch)
    jl, jcache = jm.prefill_with_cache(cfg, jp, jcache, jnp.asarray(toks),
                                       jnp.asarray([len(prompt)]),
                                       jnp.asarray(table))
    tl, tcache = tm.prefill_with_cache(
        tcfg, tp, tcache, torch.from_numpy(toks),
        torch.tensor([len(prompt)]), torch.from_numpy(table))
    _assert_same_routes(_reference_routes(cfg, jp, toks), seen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)

    def caches_close():
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name][:, 1:].numpy(),
                                       np.asarray(jcache[name])[:, 1:],
                                       atol=CACHE_ATOL)

    caches_close()
    jtok = int(np.argmax(np.asarray(jl[0])))
    assert int(torch.argmax(tl[0])) == jtok
    pos = len(prompt)
    for _ in range(5):
        jl, jcache = jm.decode_step(cfg, jp, jcache, jnp.asarray([jtok]),
                                    jnp.asarray([pos]), jnp.asarray(table))
        tl, tcache = tm.decode_step(tcfg, tp, tcache, torch.tensor([jtok]),
                                    torch.tensor([pos]),
                                    torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        caches_close()
        jtok = int(np.argmax(np.asarray(jl[0])))
        assert int(torch.argmax(tl[0])) == jtok
        pos += 1
    vtok = np.array([[jtok, 8, 30, 2]], np.int32)
    jl, jcache = jm.verify_step(cfg, jp, jcache, jnp.asarray(vtok),
                                jnp.asarray([pos]), jnp.asarray(table))
    tl, tcache = tm.verify_step(tcfg, tp, tcache, torch.from_numpy(vtok),
                                torch.tensor([pos]), torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    caches_close()


ENGINE = dict(num_blocks=48, block_size=4, max_num_seqs=4,
              prefill_token_budget=256, max_queued_requests=16)


def test_engine_greedy_streams_match_reference(model):
    cfg, tcfg, jp, tp = model
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11, 12, 13, 14, 15]]
    lens = [6, 9, 4, 7]
    je = jllm.InferenceEngine(jllm.EngineConfig(model=cfg, **ENGINE),
                              params=jp)
    try:
        reference = [list(je.generate(p, max_new_tokens=n))
                     for p, n in zip(prompts, lens)]
    finally:
        je.shutdown()
    te = tllm.InferenceEngine(
        tllm.EngineConfig(model=tcfg, device="cpu", **ENGINE), params=tp)
    try:
        port = [list(te.generate(p, max_new_tokens=n))
                for p, n in zip(prompts, lens)]
        assert te.wait_idle(30)
    finally:
        te.shutdown()
    assert port == reference


def test_shift_params_zero_the_moe_leaves_like_reference():
    cfg = dataclasses.replace(MOE, vocab_size=32, d_model=32)
    ref = jm.shift_params(cfg, shift=3)
    got = tm.shift_params(_port_cfg(cfg), shift=3, device="cpu")
    assert set(got["layers"]) == set(ref["layers"])
    for name, leaf in ref["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      np.asarray(leaf), err_msg=name)
    toks = torch.tensor([[5, 9, 2]])
    logits = tm.forward(_port_cfg(cfg), got, toks)
    assert logits[0].argmax(-1).tolist() == [8, 12, 5]
