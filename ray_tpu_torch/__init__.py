"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It stands beside the JAX package (``ray_tpu``), which stays the reference,
and imports nothing of it or of JAX. This slice covers the serving path
of the flagship decoder: ``models`` (prefill with cache, chunked prefill,
decode over a paged KV cache), ``llm`` (the continuous-batching engine)
and ``ops`` (a hand-written flash-attention forward kernel for sm_90a,
plus plain PyTorch paged attention). Entry points take a ``device`` that
defaults to ``"cuda"``; tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
