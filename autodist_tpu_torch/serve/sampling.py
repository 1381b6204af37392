"""Sampling params and the greedy token transform (PyTorch port).

Ports the JAX package's ``serve/sampling.py`` as far as this slice needs:
the per-request :class:`SamplingParams` record with its edge validation
(the typed :class:`InvalidSamplingParams`, a ``ValueError`` the HTTP front
end maps to 400), the per-slot host arrays, and the greedy branch of
:func:`sample_tokens` (``temperature <= 0`` -> the fp32 argmax, first
maximum on ties). The counter-based Gumbel draw of the stochastic branch is
not ported yet: a request with ``temperature > 0`` is refused at admission
with :class:`StochasticSamplingNotPorted`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

__all__ = [
    "InvalidSamplingParams",
    "SamplingParams",
    "StochasticSamplingNotPorted",
    "check_supported",
    "sample_tokens",
    "slot_arrays",
]


class InvalidSamplingParams(ValueError):
    """Typed rejection for malformed sampling params — a ``ValueError``
    subclass so the HTTP front end's 400 mapping catches it."""


class StochasticSamplingNotPorted(InvalidSamplingParams):
    """``temperature > 0`` asks for the stochastic draw, which this port
    does not have yet: refused at admission, never silently greedy."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling record; ``temperature=0`` means greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> "SamplingParams":
        """Return self or raise the typed :class:`InvalidSamplingParams`."""
        if not math.isfinite(self.temperature) or self.temperature < 0.0:
            raise InvalidSamplingParams(
                f"temperature must be a finite float >= 0, got "
                f"{self.temperature!r}")
        if self.top_k < 0:
            raise InvalidSamplingParams(
                f"top_k must be >= 0 (0 disables), got {self.top_k!r}")
        if not (0.0 < self.top_p <= 1.0):
            raise InvalidSamplingParams(
                f"top_p must be in (0, 1], got {self.top_p!r}")
        return self

    def to_dict(self) -> Dict[str, float]:
        return {"temperature": float(self.temperature),
                "top_k": int(self.top_k),
                "top_p": float(self.top_p),
                "seed": int(self.seed)}


def check_supported(sampling: Optional[SamplingParams]) -> None:
    """Validate ``sampling`` and refuse what this port cannot serve yet."""
    if sampling is None:
        return
    sampling.validate()
    if not sampling.greedy:
        raise StochasticSamplingNotPorted(
            f"temperature {sampling.temperature} asks for stochastic sampling, "
            "which is not yet ported to autodist_tpu_torch; send temperature 0 "
            "(greedy)")


def slot_arrays(n_slots: int):
    """Fresh host-side per-slot sampling arrays at the greedy defaults."""
    return {"temperature": np.zeros(n_slots, np.float32),
            "top_k": np.zeros(n_slots, np.int32),
            "top_p": np.ones(n_slots, np.float32),
            "key_hi": np.zeros(n_slots, np.uint32),
            "key_lo": np.zeros(n_slots, np.uint32)}


def sample_tokens(logits, temperature):
    """Greedy branch of the JAX ``sample_tokens``: ``logits [..., V]`` ->
    ``int32 [...]`` argmax in fp32 where ``temperature <= 0``. Raises
    :class:`StochasticSamplingNotPorted` if any row has ``temperature > 0``."""
    temperature = torch.as_tensor(temperature, device=logits.device)
    if bool((temperature > 0).any()):
        raise StochasticSamplingNotPorted(
            "stochastic rows (temperature > 0) are not yet ported")
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
