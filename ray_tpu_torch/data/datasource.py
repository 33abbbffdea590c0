"""Custom Datasource / Datasink protocol (counterpart of
``ray_tpu/data/datasource.py``).

A ``Datasource`` produces read tasks (zero-arg callables returning
blocks) that the streaming executor runs as ordinary input operators,
exactly how the built-in formats are wired. A ``Datasink`` receives the
dataset's blocks with start/complete/failure lifecycle hooks and
returns whatever its ``write`` calls produced.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

from ray_tpu_torch.data.block import Block


class ReadTask:
    """One unit of read parallelism: calling it yields blocks. Its
    metadata (row and byte estimates) is the caller's; the executor does
    not read it."""

    def __init__(self, fn: Callable[[], List[Block]],
                 num_rows: Optional[int] = None,
                 size_bytes: Optional[int] = None):
        self._fn = fn
        self.num_rows = num_rows
        self.size_bytes = size_bytes

    def __call__(self) -> List[Block]:
        return self._fn()


class Datasource:
    """Implement ``get_read_tasks`` to plug a custom source into
    ``ray_tpu_torch.data.read_datasource``: its tasks run through the
    same streaming executor as the built-in formats."""

    def get_read_tasks(self, parallelism: int, **options
                       ) -> List[Callable[[], List[Block]]]:
        raise NotImplementedError


class Datasink:
    """Implement ``write`` to plug a custom sink into
    ``Dataset.write_datasink``. Lifecycle: ``on_write_start`` once,
    ``write(blocks)`` over the streamed blocks (possibly in several
    calls), then ``on_write_complete(results)`` — or
    ``on_write_failed(error)`` if the stream raised."""

    def on_write_start(self) -> None:
        pass

    def write(self, blocks: Iterable[Block]) -> Any:
        raise NotImplementedError

    def on_write_complete(self, write_results: List[Any]) -> None:
        pass

    def on_write_failed(self, error: Exception) -> None:
        pass
