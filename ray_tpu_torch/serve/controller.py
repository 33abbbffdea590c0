"""ServeController: deployment reconciliation + autoscaling (counterpart
of ``ray_tpu/serve/controller.py``, trimmed to one process).

Target state (deployments + replica counts) against actual state (live
replica actors) is reconciled by a background loop; autoscaling adjusts
target counts from ongoing-request telemetry within [min_replicas,
max_replicas], down to zero and back (the wake path). A second loop
polls LLM replicas' prefix digests for the router. Replicas are the
port's actors (``max_concurrency=100``); ``scheduling_strategy="SPREAD"``
is accepted and does nothing on one machine, as in the reference
standalone. Not ported: the KV-stream fallback (``handle_stream``), as no
handle leaves the process, and the flight-recorder and tracing hooks.
``shutdown`` stops both loops, stops every replica's user object (its
``shutdown()``, where the deployment's class has one: an LLM replica's
engine loop) and kills the replicas.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch.serve.router import ReplicaSet

log = get_logger(__name__)

# Bounds on the calls the controller makes to replicas off the request
# path, and on joining its loops at shutdown.
_PROBE_TIMEOUT_S = 2.0
_STOP_TIMEOUT_S = 10.0
_JOIN_TIMEOUT_S = 5.0


@dataclass
class AutoscalingConfig:
    """``min_replicas=0`` enables SCALE-TO-ZERO: past the downscale
    delay with no ongoing requests the deployment drops its last
    replica; the next request WAKES it (queues while the controller
    scales back up, bounded by ``RAY_TPU_SERVE_WAKE_TIMEOUT_S``)
    instead of shedding."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    # Scaling signal. The default scales on the router's per-replica
    # in-flight counts; any other name is polled FROM the replicas
    # (``autoscale_metric(name)``, off the request path) and averaged.
    metric: str = "ongoing_requests"
    # Per-replica target for a custom metric (None: falls back to
    # target_ongoing_requests).
    target_value: Optional[float] = None


# Scale/wake event history is bounded (observability, not a ledger).
_SCALE_EVENTS_MAX = 256


def _record_scale_event(events: List[dict], event: dict) -> None:
    events.append(event)
    if len(events) > _SCALE_EVENTS_MAX:
        del events[:len(events) - _SCALE_EVENTS_MAX]


@dataclass
class DeploymentInfo:
    name: str
    cls: type
    init_args: tuple
    init_kwargs: dict
    num_replicas: int
    autoscaling: Optional[AutoscalingConfig]
    max_ongoing_requests: Optional[int] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    replicas: List[Any] = field(default_factory=list)
    replica_set: ReplicaSet = field(default_factory=ReplicaSet)
    status: str = "UPDATING"
    request_count: int = 0
    last_scale_change: float = 0.0
    last_prefix_poll: float = 0.0
    # Every target change (autoscale up/down, wake) as {"t_decision",
    # "from", "to", "reason"} on the monotonic clock.
    scale_events: List[dict] = field(default_factory=list)
    wake_events: int = 0
    last_wake_latency_s: float = 0.0
    # Custom autoscaling metric samples, id(replica) -> last value.
    metric_values: Dict[int, float] = field(default_factory=dict)
    last_metric_poll: float = 0.0


class ServeController:
    """In-process controller singleton: a supervisor object with a
    reconciler thread and a telemetry thread."""

    def __init__(self):
        self._deployments: Dict[str, DeploymentInfo] = {}
        self._lock = threading.RLock()
        # Reconcile passes are mutually exclusive: two concurrent passes
        # would each observe live < target and start duplicate replicas.
        # Separate from _lock: replica construction is slow (engine
        # init) and must not block status()/routing.
        self._reconcile_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True,
            name="serve-controller")
        self._thread.start()
        # Prefix-digest telemetry on its OWN thread: a slow replica
        # blocking a poll must never delay autoscaling or dead-replica
        # replacement.
        self._prefix_thread = threading.Thread(
            target=self._prefix_poll_loop, daemon=True,
            name="serve-prefix-poll")
        self._prefix_thread.start()

    # -------------------------------------------------------------- deploy
    def deploy(self, name: str, cls: type, init_args, init_kwargs,
               num_replicas: int,
               autoscaling: Optional[AutoscalingConfig],
               max_ongoing_requests: Optional[int] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None
               ) -> None:
        with self._lock:
            old = self._deployments.get(name)
            info = DeploymentInfo(
                name=name, cls=cls, init_args=init_args,
                init_kwargs=init_kwargs, num_replicas=num_replicas,
                autoscaling=autoscaling,
                max_ongoing_requests=max_ongoing_requests,
                ray_actor_options=dict(ray_actor_options or {}))
            if old is not None:
                info.replicas = old.replicas
                info.replica_set = old.replica_set
            info.replica_set.configure_admission(max_ongoing_requests)
            self._deployments[name] = info
        self._reconcile_once()

    def delete(self, name: str) -> None:
        with self._lock:
            info = self._deployments.pop(name, None)
        if info:
            for r in info.replicas:
                self._stop_replica(info, r)

    def _stop_replica(self, info: DeploymentInfo, replica) -> None:
        """Stop the replica's user object (its ``shutdown()``, where the
        class has one), then kill the replica's actor."""
        if callable(getattr(info.cls, "shutdown", None)) and \
                not replica._runtime.dead:
            try:
                ray_tpu_torch.get(replica.handle_request.remote(
                    "shutdown", (), {}), timeout=_STOP_TIMEOUT_S)
            except Exception as exc:  # noqa: BLE001 — kill regardless
                log.warning("replica shutdown() of %r failed: %r",
                            info.name, exc)
        ray_tpu_torch.kill(replica)

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete(n)
        for t in (self._thread, self._prefix_thread):
            if t is not threading.current_thread():
                t.join(_JOIN_TIMEOUT_S)

    # ----------------------------------------------------------- reconcile
    def _reconcile_loop(self):
        while not self._stop.wait(0.25):
            try:
                self._autoscale()
                self._reconcile_once()
            except Exception as exc:  # keep the controller alive
                log.warning("serve reconcile pass failed; controller "
                            "continues: %r", exc)

    # ---------------------------------------------------- prefix telemetry
    _PREFIX_POLL_INTERVAL_S = 1.0

    def _prefix_poll_loop(self):
        while not self._stop.wait(0.5):
            try:
                self._poll_prefix_digests()
            except Exception as exc:  # telemetry best-effort
                log.debug("prefix-digest poll failed; routing uses "
                          "stale overlap scores: %r", exc)
            try:
                self._poll_autoscale_metrics()
            except Exception as exc:  # telemetry best-effort
                log.debug("autoscale-metric poll failed; scaling uses "
                          "stale samples: %r", exc)

    def _poll_prefix_digests(self):
        """Refresh each prefix-capable deployment's replica digest
        reports (LLM replicas expose ``prefix_digest()``). The router
        scores replicas by cached-prefix overlap from these reports,
        off the request path; a stale report only costs a routing hit."""
        now = time.monotonic()
        with self._lock:
            infos = [i for i in self._deployments.values()
                     if hasattr(i.cls, "prefix_digest")
                     and now - i.last_prefix_poll
                     > self._PREFIX_POLL_INTERVAL_S]
        for info in infos:
            info.last_prefix_poll = now
            self.poll_prefix_digests_of(info)

    def poll_prefix_digests_of(self, info: DeploymentInfo) -> None:
        for r in list(info.replicas):
            if self._stop.is_set():
                return
            try:
                ref = r.handle_request.remote("prefix_digest", (), {})
                report = ray_tpu_torch.get(ref, timeout=_PROBE_TIMEOUT_S)
                info.replica_set.update_prefix_digest(
                    id(r), report["block_size"], report["digests"])
            except Exception as exc:  # telemetry best-effort
                log.debug("replica prefix_digest probe failed: %r", exc)

    def _poll_autoscale_metrics(self):
        """Refresh custom autoscaling metric samples: deployments whose
        ``AutoscalingConfig.metric`` is not the router-side default ask
        each replica for ``autoscale_metric(name)``. A replica that fails
        the probe keeps its last sample until it is pruned."""
        now = time.monotonic()
        with self._lock:
            infos = [i for i in self._deployments.values()
                     if i.autoscaling is not None
                     and i.autoscaling.metric != "ongoing_requests"
                     and now - i.last_metric_poll
                     > self._PREFIX_POLL_INTERVAL_S]
        for info in infos:
            info.last_metric_poll = now
            metric = info.autoscaling.metric
            replicas = list(info.replicas)
            for r in replicas:
                try:
                    ref = r.handle_request.remote(
                        "autoscale_metric", (metric,), {})
                    info.metric_values[id(r)] = float(
                        ray_tpu_torch.get(ref, timeout=_PROBE_TIMEOUT_S))
                except Exception as exc:  # telemetry best-effort
                    log.debug("replica autoscale_metric probe failed: "
                              "%r", exc)
            live = {id(r) for r in replicas}
            for k in list(info.metric_values):
                if k not in live:
                    del info.metric_values[k]

    def _reconcile_once(self):
        with self._reconcile_lock:
            with self._lock:
                infos = list(self._deployments.values())
            first_exc = None
            for info in infos:
                try:
                    self._reconcile_deployment(info)
                except Exception as exc:  # noqa: BLE001 — one deployment
                    # must not starve the others; re-raised (first) so
                    # deploy()/wake callers still observe it.
                    if first_exc is None:
                        first_exc = exc
            if first_exc is not None:
                raise first_exc

    def _reconcile_deployment(self, info: DeploymentInfo):
        target = info.num_replicas
        live = [r for r in info.replicas if not r._runtime.dead]
        try:
            while len(live) < target:
                live.append(self._start_replica(info))
            while len(live) > target:
                self._stop_replica(info, live.pop())
            info.status = "HEALTHY"
        finally:
            # Commit whatever exists even when a start raised mid-pass.
            info.replicas = live
            info.replica_set.update(live)

    def _start_replica(self, info: DeploymentInfo):
        user_cls = info.cls
        init_args, init_kwargs = info.init_args, info.init_kwargs

        @ray_tpu_torch.remote
        class Replica:
            def __init__(self):
                self._user = user_cls(*init_args, **init_kwargs)

            def _resolved(self, method, args, kwargs):
                # User args travel packed in a tuple, so chained
                # DeploymentResponse ObjectRefs are nested one level
                # deep: resolve them here (the composition contract).
                args = tuple(
                    ray_tpu_torch.get(a)
                    if isinstance(a, ray_tpu_torch.ObjectRef) else a
                    for a in args)
                kwargs = {
                    k: (ray_tpu_torch.get(v)
                        if isinstance(v, ray_tpu_torch.ObjectRef) else v)
                    for k, v in kwargs.items()
                }
                fn = (self._user if method == "__call__"
                      else getattr(self._user, method))
                return fn, args, kwargs

            def handle_request(self, method, args, kwargs):
                fn, args, kwargs = self._resolved(method, args, kwargs)
                if not callable(fn):
                    raise TypeError(
                        f"deployment {user_cls.__name__}.{method} is not "
                        f"callable")
                return fn(*args, **kwargs)

            def handle_stream_gen(self, method, args, kwargs):
                """Generator method on the streaming plane: invoked with
                ``num_returns="streaming"``, so every yield commits one
                item ref the caller's ObjectRefGenerator consumes
                incrementally, and closing it stops this loop between
                yields."""
                fn, args, kwargs = self._resolved(method, args, kwargs)
                yield from fn(*args, **kwargs)

            def health_check(self):
                return True

        # Replicas serve concurrently (reference default: 100 ongoing
        # requests per replica). SPREAD is a no-op on one machine.
        replica_opts = dict(max_concurrency=100,
                            scheduling_strategy="SPREAD")
        replica_opts.update(info.ray_actor_options)  # user keys win
        return Replica.options(**replica_opts).remote()

    # ---------------------------------------------------------- autoscale
    def _autoscale(self):
        now = time.monotonic()
        with self._lock:
            infos = list(self._deployments.values())
        for info in infos:
            cfg = info.autoscaling
            if cfg is None:
                continue
            qlens = info.replica_set.queue_lengths()
            if not qlens:
                continue
            if cfg.metric != "ongoing_requests":
                # Custom pool signal (polled from the replicas); no
                # samples yet -> hold steady rather than scale on a guess.
                vals = list(info.metric_values.values())
                if not vals:
                    continue
                ongoing = sum(vals) / len(vals)
                target = (cfg.target_value
                          if cfg.target_value is not None
                          else cfg.target_ongoing_requests)
            else:
                ongoing = sum(qlens) / len(qlens)
                target = cfg.target_ongoing_requests
            if (ongoing > target
                    and info.num_replicas < cfg.max_replicas
                    and now - info.last_scale_change > cfg.upscale_delay_s):
                _record_scale_event(info.scale_events, {
                    "t_decision": now, "from": info.num_replicas,
                    "to": info.num_replicas + 1, "reason": "load"})
                info.num_replicas += 1
                info.last_scale_change = now
            elif (ongoing < target / 2
                  and info.num_replicas > cfg.min_replicas
                  and now - info.last_scale_change > cfg.downscale_delay_s):
                if info.num_replicas == 1 and sum(qlens) > 0:
                    continue  # scale-to-zero never kills live streams
                _record_scale_event(info.scale_events, {
                    "t_decision": now, "from": info.num_replicas,
                    "to": info.num_replicas - 1, "reason": "idle"})
                info.num_replicas -= 1
                info.last_scale_change = now

    # ----------------------------------------------------------------- wake
    def wake_and_wait(self, name: str) -> None:
        """Scale-to-zero wake: a request hit a deployment with zero
        replicas. Raise the target back to one (recorded as a wake scale
        event) and QUEUE the caller until a replica is live, bounded by
        ``RAY_TPU_SERVE_WAKE_TIMEOUT_S``, past which a typed
        ``GetTimeoutError`` surfaces."""
        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch.exceptions import GetTimeoutError

        t0 = time.monotonic()
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment named {name!r}")
            if info.num_replicas == 0:
                info.wake_events += 1
                _record_scale_event(info.scale_events, {
                    "t_decision": t0, "from": 0, "to": 1,
                    "reason": "wake"})
                info.num_replicas = 1
                info.last_scale_change = t0
        deadline = t0 + float(GlobalConfig.serve_wake_timeout_s)
        while time.monotonic() < deadline:
            self._reconcile_once()
            with self._lock:
                info = self._deployments.get(name)
                size = info.replica_set.size() if info else 0
            if info is None:
                raise KeyError(f"no deployment named {name!r}")
            if size > 0:
                with self._lock:
                    info.last_wake_latency_s = time.monotonic() - t0
                return
            time.sleep(0.25)
        raise GetTimeoutError(
            f"deployment {name!r} did not wake from zero replicas "
            f"within {GlobalConfig.serve_wake_timeout_s:.0f}s "
            f"(RAY_TPU_SERVE_WAKE_TIMEOUT_S)")

    # ------------------------------------------------------------- queries
    def deployment_info(self, name: str) -> DeploymentInfo:
        with self._lock:
            info = self._deployments.get(name)
        if info is None:
            raise KeyError(f"no deployment named {name!r}")
        return info

    def _replica_set(self, name: str) -> ReplicaSet:
        info = self.deployment_info(name)
        # Lazily ensure replicas exist before first routing.
        if info.replica_set.size() == 0:
            self._reconcile_once()
        return info.replica_set

    def _record_request(self, name: str):
        with self._lock:
            info = self._deployments.get(name)
            if info:
                info.request_count += 1

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "status": info.status,
                    "replicas": len(info.replicas),
                    "target_replicas": info.num_replicas,
                    "requests": info.request_count,
                    "queue_lengths": info.replica_set.queue_lengths(),
                    "admission": info.replica_set.admission_stats(),
                    "scale_events": [dict(e)
                                     for e in info.scale_events],
                    "wake_events": info.wake_events,
                    "last_wake_latency_s": info.last_wake_latency_s,
                }
                for name, info in self._deployments.items()
            }


_controller: Optional[ServeController] = None
_controller_lock = threading.Lock()


def get_or_create_controller() -> ServeController:
    global _controller
    with _controller_lock:
        if _controller is None or _controller._stop.is_set():
            _controller = ServeController()
        return _controller


def shutdown_controller():
    global _controller
    with _controller_lock:
        ctrl, _controller = _controller, None
    if ctrl is not None:
        ctrl.shutdown()
