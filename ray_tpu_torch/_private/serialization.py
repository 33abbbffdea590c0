"""Serialization context: pickle protocol 5 with out-of-band buffers, and
device tensors kept on their device (counterpart of
``ray_tpu/_private/serialization.py``).

In the driver's store (the thread plane, and ``put``/``get`` made in the
driver) values pickle with stdlib ``pickle``: tasks carry the callable
itself, so no function crosses a process boundary there, and a value is
isolated from the caller by a copy as the reference isolates it. Large
host buffers (numpy arrays) ride pickle 5's out-of-band buffers, as in
the reference.

A tensor on a device other than the CPU (a CUDA tensor) never goes
through host bytes in the driver. The pickler's ``persistent_id`` takes
it out of the stream: ``serialize`` keeps a copy made on its device
(``tensor.detach().clone()``, on that device's current stream) in the
``SerializedObject`` beside the pickle, and ``deserialize`` hands each
reader a fresh device copy of that (``clone()`` again), with the
original's ``requires_grad`` and, for an ``nn.Parameter``, its type. So
``put``, a task argument passed by reference and a return value give a
tensor on the same device with the same values, and neither the writer's
later in-place updates nor a reader's reach the stored copy.

A value that stdlib pickle refuses (a lambda, a local class, an object
holding a lock or a thread, such as a Serve handle) is held as it is, by
reference, while it stays in the driver.

**Across a process boundary** (the process plane: arguments and results
of worker processes, and the API calls a worker makes back to the
driver) a value goes through host bytes, the *wire* form (``wire_dumps``
/ ``wire_loads``, and ``SerializedObject.to_bytes`` / ``from_bytes``):
``cloudpickle``, as the reference pickles, so functions and classes
cross by value; every strided tensor, CUDA or CPU, pickles as a CPU
tensor whose storage is one pickle-5 out-of-band buffer, with its dtype,
shape, ``requires_grad`` and ``nn.Parameter`` type. A worker process
never reaches the card, so a CUDA tensor bound for it arrives as a CPU
tensor with the same values, and a worker's result reaches the driver on
the CPU (the caller moves it to the card).

**Custom serializers.** ``register_serializer(cls, serializer=...,
deserializer=...)`` on a context puts ``cls`` in its pickler's dispatch
table, as the reference does: an instance pickles as
``deserializer(serializer(obj))``, in the driver's form and in the wire
form (a payload's ``to_bytes``, and the arguments that ``pack_args``
ships to a worker process, take the driver context's registrations).
In the driver's form the deserializer itself is kept beside the pickle,
like a device tensor, so a lambda works there as it does through
``cloudpickle``. ``deregister_serializer`` ends it for later values.

``torch`` is imported here only when ``sys.modules`` already holds it: a
value can hold a tensor only if torch is loaded, and a worker process
that runs no torch code boots without it.
"""

from __future__ import annotations

import copyreg
import io
import pickle
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

_UNPICKLABLE = (pickle.PicklingError, TypeError, AttributeError)


def _torch():
    """The torch module if this process has imported it, else None."""
    return sys.modules.get("torch")


def cloudpickle_module():
    """The ``cloudpickle`` module, or None where it does not import."""
    try:
        import cloudpickle
    except ImportError:
        return None
    return cloudpickle


def require_cloudpickle():
    """``cloudpickle``, which the process plane needs to ship functions
    and classes; an ImportError that names it where it is missing."""
    cp = cloudpickle_module()
    if cp is None:
        raise ImportError(
            "worker_mode='process' needs the cloudpickle package (functions "
            "and classes cross to worker processes by value)")
    return cp


def dumps_by_value(value: Any) -> bytes:
    """``value`` pickled for storage: with ``cloudpickle`` where it
    imports, as the reference pickles, so a closure or a function defined
    inside another is stored by value; else with stdlib pickle, which
    stores a function by its import path."""
    return (cloudpickle_module() or pickle).dumps(value, protocol=5)


class SerializedObject:
    """Pickled payload + out-of-band host buffers + device tensors (or,
    for a value pickle refuses, the value itself in ``held``), with the
    registered deserializers the payload calls and the context's custom
    serializers at the time (``custom``, for the wire form)."""

    __slots__ = ("data", "buffers", "device_tensors", "held",
                 "deserializers", "custom")

    _NOTHING = object()

    def __init__(self, data: bytes, buffers: List[pickle.PickleBuffer],
                 device_tensors: List[Tuple[Any, bool, bool]],
                 held: Any = _NOTHING, deserializers: Optional[list] = None,
                 custom: Optional[Dict[type, Tuple[Callable, Callable]]]
                 = None):
        self.data = data
        self.buffers = buffers
        self.device_tensors = device_tensors
        self.held = held
        self.deserializers = deserializers or []
        self.custom = custom

    def host_bytes(self) -> int:
        """Bytes this payload holds in host memory (what spilling can
        move to disk)."""
        return len(self.data) + sum(b.raw().nbytes for b in self.buffers)

    def total_bytes(self) -> int:
        return self.host_bytes() + sum(
            t.numel() * t.element_size() for t, _, _ in self.device_tensors)

    def on_host(self) -> bool:
        """Whether the payload is wholly host bytes: no device tensor, no
        registered deserializer and no value held by reference."""
        return (not self.device_tensors and not self.deserializers
                and self.held is SerializedObject._NOTHING)

    def to_bytes(self) -> bytes:
        """One flat buffer (for spilling and for a worker process): a
        header of lengths, the pickle, then each out-of-band buffer. A
        payload with device tensors or a held value is first re-pickled
        in the wire form (module docstring)."""
        if not self.on_host():
            return wire_dumps(SerializationContext().deserialize(self),
                              self.custom)
        return _frame(self.data, self.buffers)

    @classmethod
    def from_bytes(cls, raw) -> "SerializedObject":
        data, buffers = _unframe(raw)
        return cls(data, buffers, [])


def _frame(data: bytes, buffers) -> bytes:
    out = io.BytesIO()
    header = pickle.dumps((len(data), [b.raw().nbytes for b in buffers]))
    out.write(len(header).to_bytes(8, "little"))
    out.write(header)
    out.write(data)
    for b in buffers:
        out.write(b.raw())
    return out.getvalue()


def _unframe(raw) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    view = memoryview(raw)
    hlen = int.from_bytes(view[:8], "little")
    data_len, buf_lens = pickle.loads(view[8:8 + hlen])
    off = 8 + hlen
    data = bytes(view[off:off + data_len])
    off += data_len
    buffers = []
    for n in buf_lens:
        buffers.append(pickle.PickleBuffer(view[off:off + n]))
        off += n
    return data, buffers


class _CustomDeser:
    """Picklable thunk applying a registered deserializer."""

    def __init__(self, de):
        self.de = de

    def __call__(self, payload):
        return self.de(payload)


def _custom_table(base, custom):
    """``base`` (a dispatch table) with a reduction for each registered
    class: ``(_CustomDeser(deserializer), (serializer(obj),))``."""
    table = dict(base)
    for cls, (ser, de) in custom.items():
        table[cls] = (
            lambda obj, ser=ser, de=de: (_CustomDeser(de), (ser(obj),)))
    return table


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffers, device_tensors, deserializers,
                 custom):
        if custom:   # read by the C pickler's __init__: set it first
            self.dispatch_table = _custom_table(copyreg.dispatch_table,
                                                custom)
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self._device_tensors = device_tensors
        self._deserializers = deserializers
        self._tensor_type = getattr(_torch(), "Tensor", None)

    def persistent_id(self, obj):
        if type(obj) is _CustomDeser:
            self._deserializers.append(obj)
            return ("de", len(self._deserializers) - 1)
        if (self._tensor_type is not None
                and isinstance(obj, self._tensor_type)
                and obj.device.type != "cpu"):
            torch = _torch()
            self._device_tensors.append(
                (obj.detach().clone(), obj.requires_grad,
                 isinstance(obj, torch.nn.Parameter)))
            return len(self._device_tensors) - 1
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, buffers, device_tensors, deserializers):
        super().__init__(file, buffers=buffers)
        self._device_tensors = device_tensors
        self._deserializers = deserializers

    def persistent_load(self, pid):
        if isinstance(pid, tuple):   # ("de", i): a registered deserializer
            return self._deserializers[pid[1]]
        stored, requires_grad, parameter = self._device_tensors[pid]
        out = stored.clone()
        if parameter:
            return _torch().nn.Parameter(out, requires_grad=requires_grad)
        return out.requires_grad_(requires_grad)


class SerializationContext:
    def __init__(self):
        self._custom: Dict[type, Tuple[Callable, Callable]] = {}
        self._lock = threading.Lock()

    def register_serializer(self, cls: type, *, serializer: Callable,
                            deserializer: Callable):
        with self._lock:
            self._custom[cls] = (serializer, deserializer)

    def deregister_serializer(self, cls: type):
        with self._lock:
            self._custom.pop(cls, None)

    def custom_serializers(self) -> Dict[type, Tuple[Callable, Callable]]:
        """A snapshot of the registered (serializer, deserializer) pairs."""
        with self._lock:
            return dict(self._custom)

    def serialize(self, value: Any) -> SerializedObject:
        buffers: List[pickle.PickleBuffer] = []
        device_tensors: list = []
        deserializers: list = []
        custom = self.custom_serializers() or None
        out = io.BytesIO()
        try:
            _Pickler(out, buffers, device_tensors, deserializers,
                     custom).dump(value)
        except _UNPICKLABLE:
            return SerializedObject(b"", [], [], held=value, custom=custom)
        return SerializedObject(out.getvalue(), buffers, device_tensors,
                                deserializers=deserializers, custom=custom)

    def deserialize(self, serialized: SerializedObject) -> Any:
        if isinstance(serialized, (bytes, bytearray, memoryview)):
            return wire_loads(serialized)   # a worker process's bytes
        if serialized.held is not SerializedObject._NOTHING:
            return serialized.held
        return _Unpickler(io.BytesIO(serialized.data), serialized.buffers,
                          serialized.device_tensors,
                          serialized.deserializers).load()


# ------------------------------------------------------------- wire form
def _rebuild_tensor(buf, dtype, shape, requires_grad, parameter):
    """Inverse of the wire pickler's tensor reduction: a CPU tensor that
    owns a copy of ``buf``'s bytes."""
    import numpy as np
    import torch

    raw = np.frombuffer(buf, dtype=np.uint8).copy()
    if raw.size:
        t = torch.from_numpy(raw).view(dtype).reshape(shape)
    else:   # an empty tensor: nothing to view
        t = torch.empty(shape, dtype=dtype)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _wire_pickler_class():
    cloudpickle = require_cloudpickle()

    class _WirePickler(cloudpickle.CloudPickler):
        def __init__(self, file, buffers, custom=None):
            if custom:
                # The C pickler reads its dispatch table in __init__, so
                # it is set first (set after, it would never be used).
                self.dispatch_table = _custom_table(
                    cloudpickle.CloudPickler.dispatch_table, custom)
            super().__init__(file, protocol=5,
                             buffer_callback=buffers.append)
            self._tensor_type = getattr(_torch(), "Tensor", None)

        def reducer_override(self, obj):
            if (self._tensor_type is not None
                    and isinstance(obj, self._tensor_type)):
                reduced = _reduce_tensor(obj)
                if reduced is not None:
                    return reduced
            return super().reducer_override(obj)

    return _WirePickler


_WIRE_PICKLER = None


def _reduce_tensor(obj):
    """A strided tensor as (rebuild, (host bytes out of band, dtype,
    shape, requires_grad, is Parameter)); None for other layouts and
    subclasses, which keep torch's own reduction."""
    torch = _torch()
    if (obj.layout != torch.strided or obj.is_quantized
            or type(obj) not in (torch.Tensor, torch.nn.Parameter)):
        return None
    t = obj.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    flat = t.reshape(-1).view(torch.uint8)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(flat.numpy()), t.dtype, tuple(t.shape),
             obj.requires_grad, isinstance(obj, torch.nn.Parameter)))


def wire_dumps(value: Any, custom=None) -> bytes:
    """The wire form of ``value`` (module docstring): framed
    cloudpickle with every tensor's storage out of band, on the CPU, and
    each class of ``custom`` (a context's ``custom_serializers()``)
    through its registered pair."""
    global _WIRE_PICKLER
    if _WIRE_PICKLER is None:
        _WIRE_PICKLER = _wire_pickler_class()
    buffers: List[pickle.PickleBuffer] = []
    out = io.BytesIO()
    _WIRE_PICKLER(out, buffers, custom).dump(value)
    return _frame(out.getvalue(), buffers)


def wire_loads(raw) -> Any:
    """Inverse of ``wire_dumps`` (and of ``SerializedObject.to_bytes``)."""
    data, buffers = _unframe(raw)
    return pickle.loads(data, buffers=buffers)


class WireSerializationContext:
    """The serialization context of a worker process: values become wire
    bytes (what crosses to the driver, e.g. a collective's KV post)."""

    def serialize(self, value: Any) -> bytes:
        return wire_dumps(value)

    def deserialize(self, serialized) -> Any:
        if isinstance(serialized, SerializedObject):
            return SerializationContext().deserialize(serialized)
        return wire_loads(serialized)
