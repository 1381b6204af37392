"""Model zoo of the port, registered under the JAX package's names: the
``transformer``, ``bert_base`` and ``bert_large``, ``resnet``, ``vgg``,
``densenet``, ``inception``, ``lstm_lm``, ``ncf``, ``moe_transformer``,
``mlp`` and ``linear_regression``."""
from __future__ import annotations

# Each module registers its models when imported.
from autodist_tpu_torch.models import (densenet, inception, lstm_lm, mlp,  # noqa: F401
                                       moe, ncf, resnet, vgg)
from autodist_tpu_torch.models.moe import MoEConfig
from autodist_tpu_torch.models.spec import ModelSpec, get_model_spec, register_model
from autodist_tpu_torch.models.transformer import TransformerConfig


#: The published configurations of the JAX package's
#: ``examples/benchmark/train.py`` that the port trains at full width, as
#: ``key -> (zoo name, overrides, batch, what a step's rate counts)``: the
#: CNNs and the LSTM at batch 128 (``examples/benchmark/run_tpu_queue.py``'s
#: for Inception-v3 and VGG-16), NCF at 4096, the MoE at 32.
PUBLISHED = {
    "resnet50": ("resnet", {"depth": 50, "image_size": 224}, 128, "images"),
    "vgg16": ("vgg", {"depth": 16, "image_size": 224}, 128, "images"),
    "inceptionv3": ("inception", {"image_size": 299}, 128, "images"),
    "densenet121": ("densenet", {"depth": 121, "image_size": 224}, 128, "images"),
    "lm1b": ("lstm_lm", {}, 128, "tokens"),
    "ncf": ("ncf", {}, 4096, "examples"),
    "moe": ("moe_transformer", {}, 32, "tokens"),
}


def get_model(name: str, **overrides):
    """The config of zoo model ``name`` with ``overrides`` applied (what the
    serving entry points take); :func:`get_model_spec` gives the whole
    :class:`ModelSpec` (what ``AutoDist.build`` takes)."""
    return get_model_spec(name, **overrides).config


__all__ = ["ModelSpec", "PUBLISHED", "get_model", "get_model_spec", "register_model",
           "TransformerConfig", "MoEConfig"]
