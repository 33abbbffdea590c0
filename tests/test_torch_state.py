"""Twins of the state API, the timeline and the metrics registry: the
reference (``ray_tpu.util.state``, ``ray_tpu.util.metrics``,
``ray_tpu.timeline``) beside the port (``ray_tpu_torch.util.state``,
``ray_tpu_torch.util.metrics``, ``ray_tpu_torch.timeline``), both
runtimes up in one process (``ray_tpu.init(num_cpus=4,
worker_mode="thread")`` and ``ray_tpu_torch.init(num_cpus=4)``).

The same programs give the same task summaries, filtered task listings,
timeline events (``name``, ``ph``, ``cat``), actor and object summaries;
one LLM request served through the handle and one through the HTTP proxy
give equal tokens (the tiny model's weights from the reference's
``init_params`` through ``params_from_jax``) and equal span trees (names,
parent links, status, tags but ids and times), with
``serve.request`` parenting the engine's ``llm.*`` spans and the
``first_token`` event inside ``llm.decode``; with tracing off the
request dict carries no ``_trace`` key and nothing is recorded. The
Prometheus helpers give the same text on the same inputs. Tracers are
uninstalled by fixtures and every wait is bounded.
"""

import dataclasses
import inspect
import json
import re
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu.serve as jserve
import ray_tpu.util.metrics as ref_metrics
import ray_tpu.util.state as ref_state
import ray_tpu_torch
import ray_tpu_torch.llm as tllm
import ray_tpu_torch.serve as tserve
import ray_tpu_torch.util.metrics as port_metrics
import ray_tpu_torch.util.state as port_state
from ray_tpu._private import tracing as ref_tracing
from ray_tpu_torch import models as tm
from ray_tpu_torch._private import tracing as port_tracing

T = 60.0
RUNTIMES = {"reference": (ray_tpu, ref_state, ref_tracing, jserve),
            "port": (ray_tpu_torch, port_state, port_tracing, tserve)}

MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
PORT_MODEL = tm.TransformerConfig(
    **{f.name: getattr(MODEL, f.name) for f in dataclasses.fields(MODEL)
       if f.name != "dtype"}, dtype=torch.float32)
ENGINE = dict(num_blocks=64, block_size=4, max_num_seqs=4)
PROMPT = list(range(1, 11))
NEW_TOKENS = 5


@pytest.fixture(autouse=True)
def _clean_tracers():
    ref_tracing.uninstall()
    port_tracing.uninstall()
    yield
    ref_tracing.uninstall()
    port_tracing.uninstall()


@pytest.fixture
def runtimes():
    for rt, *_, serve in RUNTIMES.values():
        serve.shutdown()
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt, *_, serve in RUNTIMES.values():
            try:
                serve.shutdown()
            finally:
                rt.shutdown()


def _poll(cond):
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(0.02)
    return cond()


def _program(rt):
    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def bad():
        raise ValueError("boom")

    @rt.remote
    class Acc:
        def add(self, x):
            return x

    refs = [inc.remote(i) for i in range(3)]
    out = rt.get(refs, timeout=T)
    try:
        rt.get(bad.remote(), timeout=T)
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        out.append(type(exc).__name__)
    acc = Acc.remote()
    out.append(rt.get(acc.add.remote(7), timeout=T))
    kept = rt.put(np.arange(16, dtype=np.int64))
    return out, acc, kept


# ------------------------------------------------------- task listings
def test_summaries_listings_and_timeline_match_the_reference(runtimes):
    got = {}
    for side, (rt, state, *_) in RUNTIMES.items():
        values, acc, kept = _program(rt)
        _poll(lambda: sum(state.summarize_tasks().values()) >= 5
              and "RUNNING" not in state.summarize_tasks())
        tasks = state.list_tasks()
        got[side] = {
            "values": values,
            "summary": state.summarize_tasks(),
            "tasks": sorted((t.name, t.state) for t in tasks),
            "failed": sorted(t.name for t in state.list_tasks(
                filters=[("state", "=", "FAILED")])),
            "not_inc": sorted(t.name for t in state.list_tasks(
                filters=[("name", "!=", "inc")])),
            "limited": len(state.list_tasks(limit=2)),
            "timeline": [(e["name"], e["ph"], e["cat"], e["args"]["state"])
                         for e in rt.timeline()],
            "actors": [(a.class_name, a.name, a.state, a.num_restarts)
                       for a in state.list_actors()],
            "actor_summary": state.summarize_actors(),
            "kept_listed": kept.hex() in {
                o.object_id for o in state.list_objects(
                    filters=[("ready", "=", True)])},
            "timeline_equals_get_timeline":
                rt.timeline() == state.get_timeline(),
        }
        assert all(t.duration_s is None or t.duration_s >= 0 for t in tasks)
        with pytest.raises(ValueError):
            state.list_tasks(filters=[("state", "~", "x")])
        rt.kill(acc)
        del kept
    assert got["port"] == got["reference"]
    assert got["port"]["summary"] == {"FINISHED": 4, "FAILED": 1}
    assert got["port"]["failed"] == ["bad"]
    assert got["port"]["kept_listed"]


def test_timeline_writes_a_file_for_chrome(runtimes, tmp_path):
    for side, (rt, *_) in RUNTIMES.items():
        _program(rt)
        path = tmp_path / f"{side}.json"
        assert rt.timeline(filename=str(path)) == str(path)
        events = json.loads(path.read_text())
        assert events and all(e["ph"] == "X" for e in events)


def test_top_level_signatures_match_the_reference():
    for name in ("timeline", "debug_dump"):
        assert name in ray_tpu_torch.__all__
        assert (inspect.signature(getattr(ray_tpu_torch, name))
                == inspect.signature(getattr(ray_tpu, name)))


# ------------------------------------------------------ served spans
@pytest.fixture
def apps(runtimes):
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            PORT_MODEL, device="cpu")
    ref = jserve.run(jllm.build_llm_app(
        jllm.EngineConfig(model=MODEL, **ENGINE), params=jp))
    port = tserve.run(tllm.build_llm_app(
        tllm.EngineConfig(model=PORT_MODEL, device="cpu", **ENGINE),
        params=tp))
    yield {"reference": ref, "port": port}


def _stream(handle):
    return list(handle.options(stream=True).remote(
        {"prompt": PROMPT, "max_new_tokens": NEW_TOKENS}))


def _http_stream(serve):
    from importlib import import_module

    http = import_module(serve.__name__ + ".http")
    proxy = http.start_proxy(port=0)
    try:
        req = urllib.request.Request(
            f"http://{proxy.host}:{proxy.port}/llm?stream=1",
            data=json.dumps({"prompt": PROMPT,
                             "max_new_tokens": NEW_TOKENS}).encode())
        with urllib.request.urlopen(req, timeout=T) as resp:
            return [json.loads(x) for x in resp.read().split() if x]
    finally:
        http.stop_proxy()


_VOLATILE_TAGS = ("seq",)   # engine-global sequence counters


def _tree(state, trace_id):
    """(name, parent's name, status, component, tags, event names) of
    each span of one trace, sorted; ids, times and the per-process
    sequence numbers dropped."""
    spans = state.collect_trace_spans(trace_id)
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted(
        (s["name"], by_id.get(s["parent_id"], s["parent_id"]),
         s["status"], s["component"],
         tuple(sorted((k, v) for k, v in s["tags"].items()
                      if k not in _VOLATILE_TAGS)),
         tuple(n for _, n in s["events"]))
        for s in spans)


def _request_trace(state, root):
    """The one trace rooted at a span named ``root``, once its engine
    spans landed."""
    def find():
        for tid, r in state.trace_summary()["traces"].items():
            if r["root"] == root:
                names = [s["name"] for s in state.collect_trace_spans(tid)]
                if "llm.decode" in names and "task.exec" in names:
                    return tid
        return None

    return _poll(find)


def _check_timing(spans, root):
    """serve.request parents the llm.* spans, none starts before it,
    and llm.decode holds one first_token event inside its interval."""
    by_name = {s["name"]: s for s in spans}
    req = by_name["serve.request"]
    for name in ("llm.queue", "llm.prefill", "llm.decode"):
        assert by_name[name]["parent_id"] == req["span_id"]
        assert by_name[name]["t0"] >= req["t0"]
    dec = by_name["llm.decode"]
    (ts, name), = dec["events"]
    assert name == "first_token"
    # 1 us of slack: t0 + dur and the event's stamp are two wall-clock
    # sums, each rounded once.
    assert dec["t0"] <= ts <= dec["t0"] + dec["dur"] + 1e-6
    if root == "http.request":
        assert req["parent_id"] == by_name["http.request"]["span_id"]


def test_served_span_trees_match_the_reference(apps):
    trees, tokens = {}, {}
    for side, (rt, state, tracing, serve) in RUNTIMES.items():
        tracing.install()
        tokens[side] = [_stream(apps[side]), _http_stream(serve)]
        for root in ("serve.request", "http.request"):
            tid = _request_trace(state, root)
            assert tid is not None, (side, root)
            trees[(side, root)] = _tree(state, tid)
            summary = state.trace_summary(tid)
            assert summary["errors"] == 0
            _check_timing(summary["spans"], root)
            rows = state.trace_waterfall(tid)
            assert rows[0]["offset_s"] == 0.0 and rows[0]["name"] == root
    assert tokens["port"] == tokens["reference"]
    assert len(tokens["port"][0]) == NEW_TOKENS
    assert tokens["port"][0] == tokens["port"][1]
    for root in ("serve.request", "http.request"):
        assert trees[("port", root)] == trees[("reference", root)]
    names = [t[0] for t in trees[("port", "http.request")]]
    assert names == sorted(["http.request", "serve.request", "task.queue",
                            "task.exec", "llm.queue", "llm.prefill",
                            "llm.decode"])


def test_untraced_requests_record_nothing_and_carry_no_trace_key(
        apps, monkeypatch):
    from ray_tpu_torch.llm import api

    seen = []
    call = api.LLMServer.__call__

    def recording(self, request):
        seen.append(dict(request))
        return call(self, request)

    monkeypatch.setattr(api.LLMServer, "__call__", recording)
    assert _stream(apps["port"]) == _stream(apps["reference"])
    assert [sorted(r) for r in seen] == [["max_new_tokens", "prompt"]]
    assert port_tracing.tracer() is None
    assert port_state.collect_trace_spans() == []
    assert port_state.trace_summary() == {"num_traces": 0, "traces": {}}


def test_llm_engine_listings_match_the_reference(apps):
    rows = {}
    for side, (rt, state, *_) in RUNTIMES.items():
        _stream(apps[side])
        engines = state.list_llm_engines()
        assert engines
        row = dataclasses.asdict(engines[-1])
        row.pop("engine_id")
        # The engine counts a step after the step's tokens are out, so a
        # read right after the stream can miss the last one.
        assert row.pop("steps") >= NEW_TOKENS - 1
        rows[side] = (row, state.summarize_llm_engines(engines[-1:]))
    assert rows["port"] == rows["reference"]
    assert rows["port"][0]["generated_tokens"] == NEW_TOKENS


# --------------------------------------------------------- metrics
_SRC = ("# HELP ray_tpu_tasks_finished doc\n"
        "# TYPE ray_tpu_tasks_finished gauge\n"
        "ray_tpu_tasks_finished 3.0\n"
        "# TYPE other gauge\nother{k=\"v\"} 1.0\n")


def test_prometheus_helpers_match_the_reference():
    parts = [({"node": "head", "component": "head"}),
             ({"node": "n1", "component": "node"}), ({})]
    out = {}
    for side, m in (("reference", ref_metrics), ("port", port_metrics)):
        relabeled = [m.relabel_prometheus(_SRC, tags) for tags in parts]
        out[side] = (relabeled, m.merge_prometheus(relabeled),
                     m.merge_prometheus([]))
    assert out["port"] == out["reference"]
    merged = out["port"][1].splitlines()
    assert sum(ln.startswith("# TYPE ray_tpu_tasks_finished ")
               for ln in merged) == 1
    at = [i for i, ln in enumerate(merged)
          if ln.startswith("ray_tpu_tasks_finished")]
    assert len(at) == 3 and at == list(range(at[0], at[0] + 3))


def test_metric_types_render_like_the_reference():
    texts = {}
    for side, m in (("reference", ref_metrics), ("port", port_metrics)):
        m.clear_registry()
        try:
            c = m.Counter("twin_requests", "requests", tag_keys=("route",))
            c.inc(2, tags={"route": "a"})
            c.inc(tags={"route": "a"})
            g = m.Gauge("twin_depth", "depth")
            g.set(4)
            h = m.Histogram("twin_latency_s", "latency",
                            boundaries=[0.1, 1.0], tag_keys=("route",))
            for v in (0.05, 0.5, 5.0):
                h.observe(v, tags={"route": "b"})
            with pytest.raises(ValueError):
                c.inc(-1)
            with pytest.raises(ValueError):
                g.set(1, tags={"undeclared": "x"})
            texts[side] = m.export_prometheus()
        finally:
            m.clear_registry()
            if m is ref_metrics:
                m._framework = None   # the reference's clear keeps it
    assert texts["port"] == texts["reference"]
    assert 'twin_latency_s_bucket{route="b",le="+Inf"} 3' in texts["port"]


def test_framework_gauges_and_the_cluster_scrape(runtimes):
    port_tracing.install()
    with port_tracing.start_span("root"):
        _program(ray_tpu_torch)
    text = port_state.cluster_metrics()
    spans = re.search(r'ray_tpu_trace_spans_recorded\{node="driver",'
                      r'component="driver"\} (\S+)', text)
    assert spans and float(spans.group(1)) > 0
    for fam in ("ray_tpu_scheduler_backlog", "ray_tpu_tasks_finished",
                "ray_tpu_store_objects", "ray_tpu_watchdog_fires",
                "ray_tpu_flight_events_recorded"):
        assert f"# TYPE {fam} gauge" in text


def test_serve_metrics_exposes_the_registry():
    host, port = port_metrics.serve_metrics()
    try:
        g = port_metrics.Gauge("twin_served_gauge", "served")
        g.set(2)
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=T) as resp:
            body = resp.read().decode()
        assert "twin_served_gauge 2.0" in body
    finally:
        port_metrics.stop_metrics_server()
        port_metrics.clear_registry()


def test_a_traced_wake_parents_the_replica_init(runtimes):
    """Port only: a request to a deployment at zero replicas wakes it
    under its serve.request span; the wake is one serve.wake span, and
    the replica it starts constructs under it (replica.init), the
    in-process cold-start chain (the reference's crosses processes
    through RAY_TPU_TRACE_PARENT). The stash is empty after the wake."""
    port_tracing.install()
    handle = tserve.run(tllm.build_llm_app(
        tllm.EngineConfig(model=PORT_MODEL, device="cpu", **ENGINE),
        num_replicas=0))
    assert len(_stream(handle)) == NEW_TOKENS
    tid = _request_trace(port_state, "serve.request")
    spans = {s["name"]: s for s in port_state.collect_trace_spans(tid)}
    assert spans["serve.wake"]["parent_id"] == \
        spans["serve.request"]["span_id"]
    assert spans["replica.init"]["parent_id"] == \
        spans["serve.wake"]["span_id"]
    assert spans["replica.init"]["component"] == "replica"
    assert spans["serve.wake"]["tags"] == {"deployment": "llm"}
    assert port_tracing.cold_start_parent() is None
