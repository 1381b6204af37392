"""Checkpoints of the PyTorch port: sharding-agnostic save and restore in
the JAX package's format, serving export and the torch-ecosystem bridge.

- :class:`Saver` (``saver.py``): the JAX package's on-disk format, so a
  checkpoint crosses between the two packages both ways; each rank of a
  ``torch.distributed`` group writes its own blocks.
- :class:`SavedModelBuilder` / :func:`load_saved_model`
  (``saved_model.py``): a ``torch.export`` program plus its params.
- :func:`export_dcp` / :func:`import_dcp` (``dcp_compat.py``): the logical
  state through ``torch.distributed.checkpoint``, the counterpart of the
  JAX package's Orbax bridge.
"""
from autodist_tpu_torch.checkpoint.dcp_compat import export_dcp, import_dcp
from autodist_tpu_torch.checkpoint.saved_model import SavedModelBuilder, load_saved_model
from autodist_tpu_torch.checkpoint.saver import Saver, ShardedLeaf

__all__ = ["Saver", "ShardedLeaf", "SavedModelBuilder", "load_saved_model",
           "export_dcp", "import_dcp"]
