"""autodist_tpu_torch — the PyTorch/CUDA port of autodist_tpu.

The JAX package ``autodist_tpu`` stays the reference; this package mirrors
its layout module by module, imports ``torch`` and never ``jax``, and
replaces each Pallas TPU kernel with a hand-written Hopper kernel under
``csrc/``. Two slices are ported: paged-KV greedy serving of the
transformer (``models/transformer.py`` → ``ops/paged_attention.py`` →
``serve/``), and training through the strategy compiler on one card
(``api.AutoDist.build`` → ``model_item`` → ``strategy/`` →
``kernel/lowering.py`` → ``models/transformer.py`` →
``ops/flash_attention.py``).
"""

__version__ = "0.1.0"

# Registers the kernels' torch.library operators, which an exported program
# of the port calls (ops/library.py); builds nothing.
from autodist_tpu_torch.ops import library as _library  # noqa: E402,F401
