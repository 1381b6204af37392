"""Model zoo of the port. This slice serves the ``transformer``."""
from __future__ import annotations

from autodist_tpu_torch.models.transformer import TransformerConfig

_CONFIGS = {"transformer": TransformerConfig}


def get_model(name: str, **overrides):
    """The config of zoo model ``name`` with ``overrides`` applied — the
    counterpart of the JAX zoo lookup the serve CLI uses."""
    try:
        cls = _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; ported: {sorted(_CONFIGS)}") from None
    return cls(**overrides)


__all__ = ["get_model", "TransformerConfig"]
