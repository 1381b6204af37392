"""Data pipeline: native prefetching loader + sharded on-disk datasets
(PyTorch port of the JAX package's ``data/``)."""
from autodist_tpu_torch.data.loader import DataLoader
from autodist_tpu_torch.data.files import DatasetWriter, load_dataset, write_dataset

__all__ = ["DataLoader", "DatasetWriter", "load_dataset", "write_dataset"]
