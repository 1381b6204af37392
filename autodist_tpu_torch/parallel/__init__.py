"""Sequence and pipeline parallelism (PyTorch port of the JAX package's
``parallel/``): ring attention rotates K/V chunks around the mesh's ``seq``
axis by point-to-point ops on its group, Ulysses re-shards seq to heads
with one all-to-all each way so the flash kernels run on a head group,
and the pipelines stream microbatches through stages on the ``pipe``
axis (GPipe, 1F1B and the interleaved 1F1B loop behind
``AutoDist.build_pipeline``)."""
from autodist_tpu_torch.parallel.pipeline import (
    PipelineTrainStep,
    pipeline_apply,
    pipeline_apply_local,
    pipeline_value_and_grad,
)
from autodist_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_local,
    ulysses_attention,
    ulysses_attention_local,
)

__all__ = [
    "PipelineTrainStep",
    "pipeline_apply",
    "pipeline_apply_local",
    "pipeline_value_and_grad",
    "ring_attention",
    "ring_attention_local",
    "ulysses_attention",
    "ulysses_attention_local",
]
