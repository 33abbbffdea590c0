"""Twin of the reference's ``test_disagg_llm_pairing_end_to_end``
(``tests/test_serve.py``): disaggregated serving through both Serve
layers, the reference's on ``ray_tpu.init(worker_mode="thread")`` and the
port's on its one-process runtime, in one process, from the same weights
(the reference's ``init_params``, carried across by ``params_from_jax``),
at the reference test's tiny f32 config on the CPU.

Streams through ``DisaggHandle`` must equal the colocated app's and the
reference's exactly (greedy tokens), as must the publish/ack ledger, the
blocks each prompt ships (the planned tail-skip ships fewer than its
table holds), the adoption and fallback counts, and the dead-ticket
fallback's stream. Every wait is bounded.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.llm as tllm
import ray_tpu_torch.serve as tserve
from ray_tpu.llm import disagg as jdisagg
from ray_tpu.serve import controller as jcontroller
from ray_tpu_torch import models as tm
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch.llm import disagg as tdisagg
from ray_tpu_torch.serve import controller as tcontroller

T = 60.0
MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
PORT_MODEL = tm.TransformerConfig(
    **{f.name: getattr(MODEL, f.name) for f in dataclasses.fields(MODEL)
       if f.name != "dtype"}, dtype=torch.float32)
ENGINE = dict(num_blocks=128, block_size=4, max_num_seqs=4)
PROMPT = [1, 2, 3, 4, 5]
LEDGER_KEYS = ("kv_publishes", "kv_acks", "kv_expiries",
               "kv_blocks_published", "kv_blocks_acked",
               "kv_blocks_expired", "kv_bytes_published",
               "kv_publications_outstanding", "blocks_in_use",
               "held_sequences")
DECODE_KEYS = ("disagg_adopted", "disagg_fallbacks", "blocks_grafted")


class _Side:
    def __init__(self, rt, serve, llm, disagg, controller, model, params,
                 **engine):
        self.rt, self.serve, self.llm = rt, serve, llm
        self.disagg, self.controller = disagg, controller
        self.cfg = llm.EngineConfig(model=model, **ENGINE, **engine)
        self.params = params


def _sides():
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            PORT_MODEL, device="cpu")
    return (_Side(ray_tpu, jserve, jllm, jdisagg, jcontroller, MODEL, jp),
            _Side(ray_tpu_torch, tserve, tllm, tdisagg, tcontroller,
                  PORT_MODEL, tp, device="cpu"))


@pytest.fixture
def sides():
    both = _sides()
    for s in both:
        s.serve.shutdown()
        s.rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield both
    finally:
        for s in both:
            try:
                s.serve.shutdown()
            finally:
                s.rt.shutdown()


def _poll_digests(side, name):
    """The controller's prefix-digest poll of one deployment, at once
    (the poll loop would run it within its interval)."""
    ctrl = side.controller.get_or_create_controller()
    info = ctrl._deployments[name]
    for r in list(info.replicas):
        report = side.rt.get(r.handle_request.remote("prefix_digest", (),
                                                     {}), timeout=T)
        info.replica_set.update_prefix_digest(
            id(r), report["block_size"], report["digests"])


def _balanced(handle):
    deadline = time.monotonic() + T
    while True:
        st = handle.stats.remote().result(timeout=T)
        if ((st["kv_publications_outstanding"] == 0
                and st["blocks_in_use"] == 0) or time.monotonic() > deadline):
            return st
        time.sleep(0.05)


def _drive(side):
    """The reference test's sequence on one side: its observable
    outcomes."""
    serve = side.serve
    ref = serve.run(side.llm.build_llm_app(side.cfg, name="llm-ref",
                                           params=side.params), name="ref")
    req = {"prompt": PROMPT, "max_new_tokens": 8}
    out = {"colocated": list(ref.options(stream=True).remote(dict(req)))}
    papp, dapp = side.disagg.build_disagg_llm_app(side.cfg,
                                                  params=side.params)
    serve.run(papp, name="prefill")
    serve.run(dapp, name="decode")
    h = side.disagg.DisaggHandle.from_deployments()
    out["disagg"] = list(h.stream(dict(req)))
    out["paired_after_one"] = (h.paired, h.prefill_fallbacks)
    # Shared prefix, planned tail-skip: the decode pool caches the first
    # prompt now, so the second ships only the unshared tail.
    req2 = {"prompt": PROMPT + [9, 9], "max_new_tokens": 8}
    out["colocated2"] = list(ref.options(stream=True).remote(dict(req2)))
    _poll_digests(side, "llm-decode")
    out["skip_blocks"] = h._plan_skip_blocks(req2["prompt"],
                                             side.cfg.block_size)
    out["planned"] = list(h.stream_planned(dict(req2), side.cfg.block_size))
    ph = serve.get_deployment_handle("llm-prefill")
    dh = serve.get_deployment_handle("llm-decode")
    pst = _balanced(ph)
    out["ledger"] = {k: pst[k] for k in LEDGER_KEYS}
    dst = dh.stats.remote().result(timeout=T)
    out["decode"] = {k: dst[k] for k in DECODE_KEYS}
    decomp = dst["ttft_decomposition"]
    out["transfer"] = (decomp["completed"],
                       decomp["transfer_p50_s"] is not None
                       and decomp["transfer_p50_s"] >= 0)
    # Dead ticket (no ref to pull): a transparent local re-prefill.
    plain = {"prompt": [7, 7, 7], "max_new_tokens": 5}
    out["colocated3"] = list(ref.options(stream=True).remote(dict(plain)))
    bad = {**plain, "_disagg": {
        "ref": None, "first_token": out["colocated3"][0], "pub_id": 999,
        "start_block": 0, "blocks": 1, "block_size": 4, "bytes": 0}}
    t0 = time.monotonic()
    out["dead_ticket"] = list(dh.options(stream=True).remote(bad))
    out["dead_ticket_s"] = time.monotonic() - t0
    out["fallbacks"] = dh.stats.remote().result(timeout=T)[
        "disagg_fallbacks"]
    out["paired"] = (h.paired, h.prefill_fallbacks)
    return out


def test_disagg_pairing_matches_colocated_and_reference(sides):
    ref_side, port_side = sides
    want, got = _drive(ref_side), _drive(port_side)
    # The port against itself: the reference test's own checks.
    assert len(got["colocated"]) == 8
    assert got["disagg"] == got["colocated"]
    assert got["paired_after_one"] == (1, 0)
    assert got["skip_blocks"] == 1          # block [1, 2, 3, 4] is cached
    assert got["planned"] == got["colocated2"]
    assert got["ledger"]["kv_publishes"] == 2
    assert got["ledger"]["kv_acks"] == got["ledger"]["kv_publishes"]
    assert got["ledger"]["kv_publications_outstanding"] == 0
    assert got["ledger"]["blocks_in_use"] == 0
    assert got["ledger"]["held_sequences"] == 0
    # The first prompt ships its 2 blocks, the planned one only its tail:
    # 1 of the 2 blocks of its 7 tokens (and the 1 generated).
    assert got["ledger"]["kv_blocks_published"] == 3
    assert got["decode"]["disagg_adopted"] == 2
    assert got["decode"]["disagg_fallbacks"] == 0
    assert got["decode"]["blocks_grafted"] > 0
    assert got["transfer"] == (2, True)
    assert got["dead_ticket"] == got["colocated3"]
    assert got["fallbacks"] == 1 and got["paired"] == (2, 0)
    # A dead ticket falls back at once, not after the pull timeout.
    assert got["dead_ticket_s"] < GlobalConfig.llm_disagg_pull_timeout_s
    # The port against the reference: every outcome alike (the payload's
    # bytes too: f32 K and V of the same shapes).
    for key in ("colocated", "disagg", "paired_after_one", "skip_blocks",
                "colocated2", "planned", "ledger", "decode", "transfer",
                "colocated3", "dead_ticket", "fallbacks", "paired"):
        assert got[key] == want[key], key


def test_parse_matches_reference():
    cases = [
        [1, 2, 3],
        (4.0, 5, 6),
        {"prompt": [1, 2], "max_new_tokens": 3, "temperature": 0.5,
         "seed": 7, "priority": 1, "eos_token_id": 2, "_trace": "t",
         "other": 9},
        {"prompt": (3, 4)},
    ]
    for c in cases:
        assert tdisagg._parse(c) == jdisagg._parse(c)


class _Engine:
    """The two engine calls the ledger makes, counted."""

    def __init__(self):
        self.released = []

    def release_held(self, seq_id):
        self.released.append(seq_id)
        return 2


def _bare_prefill(mod):
    """A prefill replica without its engine's model: the ledger alone."""
    server = object.__new__(mod.PrefillLLMServer)
    server.engine = _Engine()
    server._pub_lock = threading.Lock()
    server._published = {}
    for k in ("kv_publishes", "kv_acks", "kv_expiries",
              "kv_blocks_published", "kv_blocks_acked",
              "kv_blocks_expired", "kv_bytes_published"):
        setattr(server, k, 0)
    return server


@pytest.mark.parametrize("ttl", [0.0, 3600.0])
def test_ttl_sweep_and_ack_ledger(monkeypatch, ttl):
    """The TTL knob (``RAY_TPU_LLM_KV_PUBLISH_TTL_S``) drives the lazy
    sweep: at TTL 0 every publication expires at the next sweep; at an
    hour none does and the ack frees it. An ack of an unknown id is
    idempotent. Both servers' ledgers move alike."""
    monkeypatch.setenv("RAY_TPU_LLM_KV_PUBLISH_TTL_S", str(ttl))
    import ray_tpu._private.config as jconfig

    assert GlobalConfig.llm_kv_publish_ttl_s == ttl
    assert jconfig.GlobalConfig.llm_kv_publish_ttl_s == ttl
    ledgers = []
    for mod, cfg in ((jdisagg, jconfig.GlobalConfig),
                     (tdisagg, GlobalConfig)):
        server = _bare_prefill(mod)
        for pub_id, blocks in ((11, 3), (12, 2)):
            server._published[pub_id] = (
                time.monotonic() + float(cfg.llm_kv_publish_ttl_s), blocks)
            server.kv_publishes += 1
            server.kv_blocks_published += blocks
        freed_sweep = server.expire_published()
        freed_ack = server.ack(11)
        freed_again = server.ack(11)
        ledgers.append({
            "freed": (freed_sweep, freed_ack, freed_again),
            "released": list(server.engine.released),
            "outstanding": sorted(server._published),
            **{k: getattr(server, k) for k in (
                "kv_publishes", "kv_acks", "kv_expiries",
                "kv_blocks_acked", "kv_blocks_expired")}})
    ref, port = ledgers
    assert port == ref
    if ttl == 0.0:
        assert port["kv_expiries"] == 2 and port["kv_blocks_expired"] == 5
        assert port["kv_acks"] == 0 and port["outstanding"] == []
    else:
        assert port["kv_expiries"] == 0 and port["kv_acks"] == 1
        assert port["kv_blocks_acked"] == 3 and port["outstanding"] == [12]
    assert (port["kv_acks"] + port["kv_expiries"] + len(port["outstanding"])
            == port["kv_publishes"])


def test_prefill_pool_config_drops_speculation():
    draft = dataclasses.replace(PORT_MODEL, n_layers=1)
    cfg = tllm.EngineConfig(model=PORT_MODEL, spec_k=3, draft_model=draft,
                            device="cpu", **ENGINE)
    pre, dec = tdisagg.build_disagg_llm_app(
        cfg, prefill_autoscaling={"max_replicas": 2},
        decode_autoscaling={"max_replicas": 3})
    assert pre.deployment.name == "llm-prefill"
    assert dec.deployment.name == "llm-decode"
    pre_cfg, dec_cfg = pre.args[0], dec.args[0]
    assert pre_cfg.spec_k == 0 and pre_cfg.draft_model is None
    assert dec_cfg is cfg
    assert pre.deployment.autoscaling_config["metric"] == "queue_depth"
    assert dec.deployment.autoscaling_config["metric"] == "kv_blocks_in_use"
