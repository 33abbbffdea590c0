"""Serialization context: stdlib pickle protocol 5 with out-of-band
buffers, and device tensors kept on their device (counterpart of
``ray_tpu/_private/serialization.py``).

The reference pickles with ``cloudpickle``, which the card's machine
does not have. In one process functions and classes never cross a
process boundary (tasks carry the callable itself), so stdlib ``pickle``
covers what the store holds: values, isolated from the caller by a copy
as the reference isolates them. Large host buffers (numpy arrays) ride
pickle 5's out-of-band buffers, as in the reference.

A tensor on a device other than the CPU (a CUDA tensor) never goes
through host bytes. The pickler's ``persistent_id`` takes it out of the
stream: ``serialize`` keeps a copy made on its device
(``tensor.detach().clone()``, on that device's current stream) in the
``SerializedObject`` beside the pickle, and ``deserialize`` hands each
reader a fresh device copy of that (``clone()`` again), with the
original's ``requires_grad`` and, for an ``nn.Parameter``, its type. So
``put``, a task argument passed by reference and a return value give a
tensor on the same device with the same values, and neither the writer's
later in-place updates nor a reader's reach the stored copy.

A value that stdlib pickle refuses (a lambda, a local class, an object
holding a lock or a thread, such as a Serve handle) is held as it is, by
reference: no process boundary asks for a copy.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, List, Tuple

import torch

_UNPICKLABLE = (pickle.PicklingError, TypeError, AttributeError)


class SerializedObject:
    """Pickled payload + out-of-band host buffers + device tensors (or,
    for a value pickle refuses, the value itself in ``held``)."""

    __slots__ = ("data", "buffers", "device_tensors", "held")

    _NOTHING = object()

    def __init__(self, data: bytes, buffers: List[pickle.PickleBuffer],
                 device_tensors: List[Tuple[torch.Tensor, bool, bool]],
                 held: Any = _NOTHING):
        self.data = data
        self.buffers = buffers
        self.device_tensors = device_tensors
        self.held = held

    def total_bytes(self) -> int:
        return (len(self.data)
                + sum(b.raw().nbytes for b in self.buffers)
                + sum(t.numel() * t.element_size()
                      for t, _, _ in self.device_tensors))


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffers, device_tensors):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self._device_tensors = device_tensors

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            self._device_tensors.append(
                (obj.detach().clone(), obj.requires_grad,
                 isinstance(obj, torch.nn.Parameter)))
            return len(self._device_tensors) - 1
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, buffers, device_tensors):
        super().__init__(file, buffers=buffers)
        self._device_tensors = device_tensors

    def persistent_load(self, pid):
        stored, requires_grad, parameter = self._device_tensors[pid]
        out = stored.clone()
        if parameter:
            return torch.nn.Parameter(out, requires_grad=requires_grad)
        return out.requires_grad_(requires_grad)


class SerializationContext:
    def serialize(self, value: Any) -> SerializedObject:
        buffers: List[pickle.PickleBuffer] = []
        device_tensors: list = []
        out = io.BytesIO()
        try:
            _Pickler(out, buffers, device_tensors).dump(value)
        except _UNPICKLABLE:
            return SerializedObject(b"", [], [], held=value)
        return SerializedObject(out.getvalue(), buffers, device_tensors)

    def deserialize(self, serialized: SerializedObject) -> Any:
        if serialized.held is not SerializedObject._NOTHING:
            return serialized.held
        return _Unpickler(io.BytesIO(serialized.data), serialized.buffers,
                          serialized.device_tensors).load()
