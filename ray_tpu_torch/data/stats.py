"""Per-op execution stats (counterpart of ``ray_tpu/data/stats.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class OpStats:
    name: str
    wall_s: float
    output_blocks: int
    output_rows: int


@dataclass
class DatasetStats:
    ops: List[OpStats] = field(default_factory=list)
    total_wall_s: float = 0.0

    def summary(self) -> str:
        lines = ["Operator stats:"]
        for op in self.ops:
            rate = op.output_rows / op.wall_s if op.wall_s > 0 else 0.0
            lines.append(
                f"  {op.name}: {op.wall_s * 1e3:.1f}ms, "
                f"{op.output_blocks} blocks, {op.output_rows} rows "
                f"({rate:,.0f} rows/s)")
        lines.append(f"Total: {self.total_wall_s * 1e3:.1f}ms")
        return "\n".join(lines)
