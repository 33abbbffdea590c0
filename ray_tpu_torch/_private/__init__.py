"""The one-process runtime's internals (counterpart of
``ray_tpu/_private``, trimmed to the thread plane)."""
