"""Logical plan and optimizer rules for Data pipelines (counterpart of
``ray_tpu/data/logical.py``).

A Dataset records declarative ``LogicalOp`` nodes; nothing executes at
transform time. Consumption optimizes the plan (rule passes over the
logical op list) and only then plans physical operators
(``data/executor.py``). Rules:

- ``map_fusion_rule`` — adjacent map-class ops compose into one op, so a
  ``map -> filter -> map_batches`` chain costs one task per block.
- ``read_map_fusion_rule`` — a map chain directly after a read fuses
  into the read tasks themselves.
- ``limit_merge_rule`` — adjacent limits collapse to the minimum.
- ``limit_pushdown_rule`` — a limit hops backward over row-preserving
  (1:1) maps, trimming rows before the map computes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class LogicalOp:
    """One declarative plan node. ``kind`` drives the optimizer; the
    payload fields carry what the planner needs to emit a physical op."""

    kind: str                        # read | map | limit | barrier | custom
    name: str
    make_physical: Callable[["LogicalOp"], Any]
    block_fn: Optional[Callable] = None       # kind == "map"
    read_tasks: Optional[List[Callable]] = None   # kind == "read"
    limit: Optional[int] = None               # kind == "limit"
    # 1:1 row mapping (map/add_column/select...): limits may hop over it.
    row_preserving: bool = False
    params: Dict[str, Any] = field(default_factory=dict)


def _compose(f: Callable, g: Callable) -> Callable:
    def composed(block):
        out = []
        for b in f(block):
            out.extend(g(b))
        return out

    return composed


def map_fusion_rule(ops: List[LogicalOp]) -> List[LogicalOp]:
    out: List[LogicalOp] = []
    for op in ops:
        prev = out[-1] if out else None
        if (op.kind == "map" and prev is not None and prev.kind == "map"):
            out[-1] = replace(
                prev, name=f"{prev.name}->{op.name}",
                block_fn=_compose(prev.block_fn, op.block_fn),
                row_preserving=prev.row_preserving and op.row_preserving)
            continue
        out.append(op)
    return out


def read_map_fusion_rule(ops: List[LogicalOp]) -> List[LogicalOp]:
    out: List[LogicalOp] = []
    for op in ops:
        prev = out[-1] if out else None
        if (op.kind == "map" and prev is not None and prev.kind == "read"):
            g = op.block_fn

            def _wrap(task, g=g):
                def read_then_map():
                    res = []
                    for b in task():
                        res.extend(g(b))
                    return res

                return read_then_map

            out[-1] = replace(
                prev, name=f"{prev.name}->{op.name}",
                read_tasks=[_wrap(t) for t in prev.read_tasks])
            continue
        out.append(op)
    return out


def limit_merge_rule(ops: List[LogicalOp]) -> List[LogicalOp]:
    out: List[LogicalOp] = []
    for op in ops:
        prev = out[-1] if out else None
        if op.kind == "limit" and prev is not None and prev.kind == "limit":
            out[-1] = replace(prev, limit=min(prev.limit, op.limit))
            continue
        out.append(op)
    return out


def limit_pushdown_rule(ops: List[LogicalOp]) -> List[LogicalOp]:
    """Bubble each limit leftward across row-preserving maps: trimming N
    rows BEFORE a 1:1 map computes them is always equivalent."""
    out = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(out)):
            if (out[i].kind == "limit" and out[i - 1].kind == "map"
                    and out[i - 1].row_preserving):
                out[i], out[i - 1] = out[i - 1], out[i]
                changed = True
    return out


# Order matters: limits settle into place first, then maps (now adjacent)
# fuse, then surviving head maps fuse into their read.
DEFAULT_RULES = (limit_merge_rule, limit_pushdown_rule,
                 map_fusion_rule, read_map_fusion_rule)


class LogicalPlan:
    def __init__(self, ops: Optional[List[LogicalOp]] = None):
        self.ops: List[LogicalOp] = list(ops or [])

    def append(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def optimize(self, rules=DEFAULT_RULES) -> "LogicalPlan":
        ops = self.ops
        for rule in rules:
            ops = rule(ops)
        return LogicalPlan(ops)

    def to_physical(self) -> List[Any]:
        """Plan each logical node into a physical operator
        (data/executor.py's Operator classes)."""
        return [op.make_physical(op) for op in self.ops]

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)


def physical_op(op: Any, name: Optional[str] = None) -> LogicalOp:
    """Wrap an already-physical operator (custom sources, barriers) as an
    opaque plan node the optimizer will not touch."""
    return LogicalOp(kind="custom", name=name or op.name,
                     make_physical=lambda _lo, _op=op: _op)
