"""autodist_tpu_torch — the PyTorch/CUDA port of autodist_tpu.

The JAX package ``autodist_tpu`` stays the reference; this package mirrors
its layout module by module, imports ``torch`` and never ``jax``, and
replaces each Pallas TPU kernel with a hand-written Hopper kernel under
``csrc/``. The first slice is paged-KV greedy serving of the transformer:
``models/transformer.py`` → ``ops/paged_attention.py`` (the CUDA kernel) →
``serve/`` (engine, continuous batcher, HTTP front end).
"""

__version__ = "0.1.0"
