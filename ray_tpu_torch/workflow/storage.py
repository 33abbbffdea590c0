"""Durable workflow storage and journal (counterpart of
``ray_tpu/workflow/storage.py``).

A ``WorkflowStorage`` keeps what a workflow needs to survive its
driver's death under one root: a local directory or a URI that
``data/filesystem.py``'s registry resolves (``memory://`` lives in the
runtime's KV). Layout, as in the reference::

    <root>/<workflow_id>/dag.pkl                      # the step DAG
    <root>/<workflow_id>/meta.json                    # status record
    <root>/<workflow_id>/result.pkl                   # final output
    <root>/<workflow_id>/steps/<step_id>/output.<token>.pkl
    <root>/<workflow_id>/steps/<step_id>/commit.json  # the commit marker
    <root>/virtual_actors/<actor_id>/state.<token>.pkl + commit.<seq>.json

Exactly once is the commit protocol: a step's output is written under a
fresh token, then ``commit.json`` naming that token is created with an
exclusive create and read back. A step is committed iff its marker
parses; of racing committers exactly one wins, and the others adopt the
winner's token.

The workflow's status is also journaled in the runtime's KV under
``wfj|<id>`` while a runtime is up, so ``list_workflows`` finds it
without a scan.

Everything is pickled as the reference pickles it: with ``cloudpickle``
where it imports, else with the standard library's ``pickle``. With
``cloudpickle`` a step defined inside a function is stored by value, and
another process can resume its workflow. With ``pickle`` a step's
function pickles by reference; where pickle refuses the DAG (a step
defined inside a function), ``save_dag`` keeps it in a table of this
process, keyed by root and id, and the status record names the step: a
rerun or resume in this process works; a resume in another process
raises ``ValueError`` naming the step to define at module level.
"""

from __future__ import annotations

import json
import pickle
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.serialization import (
    cloudpickle_module,
    dumps_by_value,
)
from ray_tpu_torch.data.filesystem import resolve_filesystem

# Workflow status lifecycle (journaled and stored in meta.json).
RUNNING = "RUNNING"
SUCCESS = "SUCCESS"
FAILED = "FAILED"

JOURNAL_PREFIX = b"wfj|"
# The status record's key naming the step that kept the DAG in-process.
HELD_KEY = "dag_held_in_process"

# (root, workflow_id) -> (dag, step name): DAGs that pickle refused.
_HELD_DAGS: Dict[Tuple[str, str], Tuple[Any, Optional[str]]] = {}
_held_lock = threading.Lock()


def _loads(data: bytes) -> Any:
    return pickle.loads(data)


def _unpicklable_step(dag: Any) -> Optional[str]:
    """The name of the first step (in topological order) whose function
    pickle refuses, or None."""
    for node in dag.topological_order():
        pickles = getattr(node, "_fn_pickles", None)
        if pickles is not None and not pickles():
            return node.step_name
    return None


def _kv_worker():
    """The live runtime's KV, or None when no runtime is up (storage then
    stands alone)."""
    from ray_tpu_torch._private.worker import try_live_worker

    return try_live_worker()


class WorkflowStorage:
    """One storage root's workflow persistence."""

    def __init__(self, root: str):
        self.root = root.rstrip("/")
        self._fs, self._base = resolve_filesystem(self.root)
        self._base = self._base.rstrip("/")
        if not getattr(self._fs, "atomic_put_if_absent", False):
            # Exactly once rests on an exclusive create of the marker. A
            # backend without one gives one winner on a best-effort basis
            # when resumes race.
            import warnings

            warnings.warn(
                f"workflow storage {self.root!r}: backend has no atomic "
                f"exclusive-create; exactly-once step commits degrade "
                f"to best-effort when multiple resumes race (a single "
                f"resumer is unaffected)", RuntimeWarning,
                stacklevel=3)

    # ------------------------------------------------------------ raw IO
    def _key(self, rel: str) -> str:
        return f"{self._base}/{rel}"

    def _write(self, rel: str, data: bytes) -> None:
        key = self._key(rel)
        self._fs.makedirs(key.rsplit("/", 1)[0])
        with self._fs.open(key, "wb") as f:
            f.write(data)

    def _read(self, rel: str) -> Optional[bytes]:
        try:
            with self._fs.open(self._key(rel), "rb") as f:
                return f.read()
        except OSError:
            return None

    def _exists(self, rel: str) -> bool:
        return self._fs.exists(self._key(rel))

    def _write_if_absent(self, rel: str, data: bytes) -> bool:
        key = self._key(rel)
        self._fs.makedirs(key.rsplit("/", 1)[0])
        return self._fs.put_if_absent(key, data)

    def _read_json(self, rel: str) -> Optional[dict]:
        raw = self._read(rel)
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return None  # a torn write (crash mid-commit): not committed

    # ------------------------------------------------------- workflow meta
    def save_dag(self, workflow_id: str, dag: Any) -> None:
        """``dag.pkl``. With the standard library's pickle, a DAG that
        pickle refuses is held in this process instead (module
        docstring); ``cloudpickle``'s refusals raise, as the
        reference's do."""
        key = (self.root, workflow_id)
        try:
            data = dumps_by_value(dag)
        except Exception:  # noqa: BLE001 — pickle's refusals vary in type
            if cloudpickle_module() is not None:
                raise
            with _held_lock:
                _HELD_DAGS[key] = (dag, _unpicklable_step(dag))
            if hasattr(self._fs, "delete") and self._exists(
                    f"{workflow_id}/dag.pkl"):
                self._fs.delete(self._key(f"{workflow_id}/dag.pkl"))
            return
        with _held_lock:
            _HELD_DAGS.pop(key, None)
        self._write(f"{workflow_id}/dag.pkl", data)

    def load_dag(self, workflow_id: str) -> Any:
        with _held_lock:
            held = _HELD_DAGS.get((self.root, workflow_id))
        if held is not None:
            return held[0]
        raw = self._read(f"{workflow_id}/dag.pkl")
        if raw is not None:
            return _loads(raw)
        rec = self._read_json(f"{workflow_id}/meta.json") or {}
        if HELD_KEY in rec:
            step = rec[HELD_KEY]
            what = (f"step {step!r}, whose function" if step
                    else "an argument that")
            raise ValueError(
                f"workflow {workflow_id!r} under {self.root!r} was run "
                f"with {what} the standard library's pickle cannot store; "
                f"its DAG lived only in the process that ran it. Define "
                f"the step's function at module level to resume it from "
                f"another process.")
        raise ValueError(
            f"workflow {workflow_id!r} has no persisted DAG under "
            f"{self.root!r} — was it ever run against this storage?")

    def set_status(self, workflow_id: str, status: str,
                   error: Optional[str] = None) -> None:
        """Write the status record to storage and to the KV journal.
        Storage is what resume reads; the journal makes interrupted
        workflows discoverable."""
        rec = {
            "workflow_id": workflow_id,
            "status": status,
            "root": self.root,
            "updated_at": time.time(),
        }
        if error is not None:
            rec["error"] = error
        with _held_lock:
            held = _HELD_DAGS.get((self.root, workflow_id))
        if held is not None:
            rec[HELD_KEY] = held[1]
        self._write(f"{workflow_id}/meta.json", json.dumps(rec).encode())
        w = _kv_worker()
        if w is not None:
            w.kv_put(JOURNAL_PREFIX + workflow_id.encode(),
                     json.dumps(rec).encode())

    def get_status(self, workflow_id: str) -> Optional[dict]:
        rec = self._read_json(f"{workflow_id}/meta.json")
        if rec is not None:
            return rec
        # The journal covers a crash between its write and meta.json's.
        # Only a record journaled for this root counts.
        w = _kv_worker()
        if w is not None:
            raw = w.kv_get(JOURNAL_PREFIX + workflow_id.encode())
            if raw is not None:
                rec = json.loads(raw.decode())
                if rec.get("root") == self.root:
                    return rec
        return None

    def list_workflows(self) -> List[dict]:
        """Status records of every workflow under this root: the
        storage's immediate children and the KV journal's entries for
        this root."""
        by_id: Dict[str, dict] = {}
        try:
            seen_ids = {c for c in self._fs.children(self._base)
                        if c and c != "virtual_actors"}
        except (OSError, ValueError):
            seen_ids = set()
        for wid in sorted(seen_ids):
            rec = self._read_json(f"{wid}/meta.json")
            by_id[wid] = rec or {"workflow_id": wid, "status": RUNNING,
                                 "root": self.root}
        w = _kv_worker()
        if w is not None:
            for key in w.kv_keys(JOURNAL_PREFIX):
                raw = w.kv_get(key)
                if raw is None:
                    continue
                rec = json.loads(raw.decode())
                if rec.get("root") == self.root:
                    by_id.setdefault(rec["workflow_id"], rec)
        return [by_id[k] for k in sorted(by_id)]

    def delete_workflow(self, workflow_id: str) -> None:
        self._delete_tree(f"{workflow_id}")
        with _held_lock:
            _HELD_DAGS.pop((self.root, workflow_id), None)
        w = _kv_worker()
        if w is not None:
            w.kv_del(JOURNAL_PREFIX + workflow_id.encode())

    def _delete_tree(self, rel: str) -> None:
        base = self._key(rel)
        if hasattr(self._fs, "delete"):
            try:
                for key in self._fs.listdir(base):
                    self._fs.delete(key)
            except (OSError, ValueError):
                pass
        if "://" not in base:
            # A local root: the emptied directory tree goes too.
            import shutil

            shutil.rmtree(base, ignore_errors=True)

    # ------------------------------------------------------- step commits
    def step_commit_record(self, workflow_id: str,
                           step_id: str) -> Optional[dict]:
        """The commit marker, or None when the step has not committed (a
        missing or torn marker: the step runs again)."""
        rec = self._read_json(f"{workflow_id}/steps/{step_id}/commit.json")
        if rec is None or "token" not in rec:
            return None
        return rec

    def commit_step(self, workflow_id: str, step_id: str, value: Any,
                    meta: Optional[dict] = None) -> Tuple[bool, dict]:
        """Commit a step's output exactly once. Returns ``(won, marker)``:
        ``won`` is False when another committer's marker names another
        token, whose output the caller must take as the step's."""
        existing = self.step_commit_record(workflow_id, step_id)
        if existing is not None:
            return False, existing
        token = uuid.uuid4().hex
        base = f"{workflow_id}/steps/{step_id}"
        self._write(f"{base}/output.{token}.pkl", dumps_by_value(value))
        marker = dict(meta or {})
        marker["token"] = token
        marker["committed_at"] = time.time()
        # The marker's exclusive create decides the one winner; losers
        # adopt the winner's token. No committed output is overwritten.
        won = self._write_if_absent(
            f"{base}/commit.json", json.dumps(marker).encode())
        final = self.step_commit_record(workflow_id, step_id)
        if final is None:
            raise IOError(
                f"commit marker for {workflow_id}/{step_id} unreadable "
                f"immediately after write")
        return won and final.get("token") == token, final

    def load_step_output(self, workflow_id: str, step_id: str) -> Any:
        rec = self.step_commit_record(workflow_id, step_id)
        if rec is None:
            raise ValueError(
                f"step {step_id!r} of workflow {workflow_id!r} has no "
                f"committed output")
        raw = self._read(
            f"{workflow_id}/steps/{step_id}/output.{rec['token']}.pkl")
        if raw is None:
            raise IOError(
                f"step {step_id!r} marker names token {rec['token']} but "
                f"its output file is missing")
        return _loads(raw)

    # ------------------------------------------------------- final result
    def save_result(self, workflow_id: str, value: Any) -> None:
        self._write(f"{workflow_id}/result.pkl", dumps_by_value(value))

    def load_result(self, workflow_id: str) -> Any:
        raw = self._read(f"{workflow_id}/result.pkl")
        if raw is None:
            raise ValueError(
                f"workflow {workflow_id!r} has no stored result")
        return _loads(raw)

    def has_result(self, workflow_id: str) -> bool:
        return self._exists(f"{workflow_id}/result.pkl")

    # ----------------------------------------------------- virtual actors
    # After each commit, snapshots more than this many sequence numbers
    # behind are pruned: only the highest committed one is ever read.
    ACTOR_KEEP_SNAPSHOTS = 3

    def save_actor_state(self, actor_id: str, state: Any,
                         seq: int) -> bool:
        """Commit snapshot ``seq`` with the steps' exclusive-marker
        protocol (one ``commit.<seq>.json`` per sequence number). False
        when a concurrent writer committed this seq first."""
        token = uuid.uuid4().hex
        base = f"virtual_actors/{actor_id}"
        self._write(f"{base}/state.{token}.pkl", dumps_by_value(state))
        won = self._write_if_absent(
            f"{base}/commit.{seq:08d}.json", json.dumps(
                {"token": token, "seq": seq,
                 "committed_at": time.time()}).encode())
        if won:
            self._prune_actor_snapshots(actor_id, seq)
        return won

    def _prune_actor_snapshots(self, actor_id: str, latest_seq: int
                               ) -> None:
        """Delete markers, and their state files, more than
        ACTOR_KEEP_SNAPSHOTS behind the seq just committed."""
        if not hasattr(self._fs, "delete"):
            return
        base = f"virtual_actors/{actor_id}"
        cutoff = latest_seq - self.ACTOR_KEEP_SNAPSHOTS
        if cutoff < 0:
            return
        for key in self._fs.listdir(self._key(base)):
            name = key.rsplit("/", 1)[-1]
            if not (name.startswith("commit.") and name.endswith(".json")):
                continue
            try:
                seq = int(name[len("commit."):-len(".json")])
            except ValueError:
                continue
            if seq >= cutoff:
                continue
            rec = self._read_json(f"{base}/{name}")
            self._fs.delete(key)
            if rec and "token" in rec:
                self._fs.delete(
                    self._key(f"{base}/state.{rec['token']}.pkl"))

    def load_actor_state(self, actor_id: str) -> Optional[Tuple[Any, int]]:
        """The highest committed snapshot and its seq (markers are
        written once per seq, so the highest is the latest state)."""
        base = f"virtual_actors/{actor_id}"
        try:
            keys = self._fs.listdir(self._key(base))
        except (OSError, ValueError):
            return None
        markers = sorted(k for k in keys
                         if k.rsplit("/", 1)[-1].startswith("commit.")
                         and k.endswith(".json"))
        for key in reversed(markers):  # newest first; skip torn tails
            name = key.rsplit("/", 1)[-1]
            rec = self._read_json(f"{base}/{name}")
            if rec is None or "token" not in rec:
                continue
            raw = self._read(f"{base}/state.{rec['token']}.pkl")
            if raw is None:
                continue
            return _loads(raw), int(
                rec.get("seq", int(name[len("commit."):-len(".json")])))
        return None

    def list_actors(self) -> List[str]:
        try:
            return sorted(
                self._fs.children(f"{self._base}/virtual_actors"))
        except (OSError, ValueError):
            return []
