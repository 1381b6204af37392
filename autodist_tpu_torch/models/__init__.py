"""Model zoo of the port: the ``transformer``, the BERT configs and ``resnet``."""
from __future__ import annotations

from autodist_tpu_torch.models import resnet as _resnet  # noqa: F401  (registers "resnet")
from autodist_tpu_torch.models.spec import ModelSpec, get_model_spec, register_model
from autodist_tpu_torch.models.transformer import TransformerConfig


def get_model(name: str, **overrides):
    """The config of zoo model ``name`` with ``overrides`` applied (what the
    serving entry points take); :func:`get_model_spec` gives the whole
    :class:`ModelSpec` (what ``AutoDist.build`` takes)."""
    return get_model_spec(name, **overrides).config


__all__ = ["ModelSpec", "get_model", "get_model_spec", "register_model",
           "TransformerConfig"]
