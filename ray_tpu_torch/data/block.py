"""Blocks: the unit of data movement (counterpart of
``ray_tpu/data/block.py``).

A block is a **columnar dict of numpy arrays**, the format that
``Dataset.iter_torch_batches`` hands to the card. The reference's
conversions to pandas and Arrow are left out: the card's machine has
neither package.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]]

    @staticmethod
    def of(block: Block) -> "BlockMetadata":
        return BlockMetadata(
            num_rows=block_num_rows(block),
            size_bytes=block_size_bytes(block),
            schema={k: str(v.dtype) for k, v in block.items()},
        )


def normalize_block(data: Any) -> Block:
    """Coerce rows, a dict of columns or an array into a columnar numpy
    block."""
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        if data and isinstance(data[0], dict):
            keys = data[0].keys()
            return {k: np.asarray([row[k] for row in data]) for k in keys}
        return {"item": np.asarray(data)}
    if isinstance(data, np.ndarray):
        return {"item": data}
    raise TypeError(f"cannot convert {type(data).__name__} to a block")


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_size_bytes(block: Block) -> int:
    total = 0
    for v in block.values():
        if v.dtype == object:
            total += sum(sys.getsizeof(x) for x in v)
        else:
            total += v.nbytes
    return total


def block_slice(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def block_take_indices(block: Block, idx: np.ndarray) -> Block:
    return {k: v[idx] for k, v in block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_to_rows(block: Block) -> List[Dict[str, Any]]:
    n = block_num_rows(block)
    keys = list(block.keys())
    return [{k: block[k][i] for k in keys} for i in range(n)]
