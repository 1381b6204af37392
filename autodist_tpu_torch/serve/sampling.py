"""Counter-based stochastic sampling — the port's one sampling home.

Ports the JAX package's ``serve/sampling.py``:

1. :class:`SamplingParams`, the per-request record (temperature, ``top_k``,
   ``top_p``, ``seed``; greedy is ``temperature=0``), validated once at the
   edge: :meth:`SamplingParams.validate` raises the typed
   :class:`InvalidSamplingParams`, a ``ValueError`` the HTTP front end maps
   to 400.
2. The stateless counter-based draw: the noise for the token at absolute
   position ``t`` of request ``r`` is a pure function of ``(r.request_id,
   r.seed, t)`` — a blake2b-derived threefry key (:func:`request_key`)
   folded with the position counter. The JAX package draws it with
   ``jax.random.fold_in`` and ``jax.random.gumbel`` on a raw threefry2x32
   key; :func:`threefry2x32`, :func:`fold_in`, :func:`random_bits` and
   :func:`gumbel` compute the same uint32 bits in ``int64`` tensor
   arithmetic (masked to 32 bits, so no ``uint32`` shift or rotate support
   is needed on any device), and the Gumbel floats by the same mantissa
   construction. The streams are therefore JAX's token for token, up to
   ``log``'s last-ulp differences at near-ties.
3. :func:`sample_tokens`, the batched transform in JAX's order:
   temperature scale, top-k threshold from a descending sort, softmax,
   top-p on the exclusive prefix sum, Gumbel-argmax; rows with
   ``temperature <= 0`` return exactly the fp32 argmax.

Speculative decode stays lossless for any draft: the draft proposes with
the target's ``(key, position)`` noise over its own distribution, and
verify accepts the leading proposals equal to the target's own draw, so
emitted tokens are the plain stochastic stream's (``serve/spec.py``).

Plain PyTorch, as the JAX transform is plain ``jnp``: no kernel.
``python -m autodist_tpu_torch.serve --selftest-sampling`` is the CPU
proof (:func:`selftest_sampling`).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# The threefry primitives live in utils/prng.py (PowerSGD's initial q draws
# from them too); re-exported here under their names.
from autodist_tpu_torch.utils.prng import fold_in, random_bits, threefry2x32

__all__ = [
    "InvalidSamplingParams",
    "SamplingParams",
    "TEMPERATURE_BUCKETS",
    "chi_square_fits",
    "fold_in",
    "gumbel",
    "random_bits",
    "request_key",
    "sample_tokens",
    "selftest_sampling",
    "slot_arrays",
    "temperature_bucket",
    "threefry2x32",
]

SAMP_KEYS = ("temperature", "top_k", "top_p", "key_hi", "key_lo")


class InvalidSamplingParams(ValueError):
    """Typed rejection for malformed sampling params — a ``ValueError``
    subclass so the HTTP front end's 400 mapping catches it."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling record; ``temperature=0`` means greedy.

    ``top_k <= 0`` disables the top-k mask; ``top_p`` lies in ``(0, 1]``
    (1.0 disables the nucleus mask). ``seed`` feeds :func:`request_key`
    beside the request id, so the same ``(request_id, seed)`` replays the
    same stream and another seed draws a fresh one."""

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

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["SamplingParams"]:
        """Rebuild from a dict of the four fields; ``None``/``{}`` ->
        ``None`` (greedy). Malformed values raise the typed error."""
        if not d:
            return None
        try:
            params = cls(temperature=float(d.get("temperature", 0.0)),
                         top_k=int(d.get("top_k", 0)),
                         top_p=float(d.get("top_p", 1.0)),
                         seed=int(d.get("seed", 0)))
        except (TypeError, ValueError, AttributeError) as err:
            raise InvalidSamplingParams(f"malformed sampling dict: {err}") from err
        return params.validate()


def request_key(request_id: str, seed: int) -> Tuple[int, int]:
    """The per-request threefry key (two uint32 words): blake2b over
    ``request_id\\0seed``, as the JAX package derives it. A pure function
    of ``(request_id, seed)``: no engine, cache or batch state enters."""
    h = hashlib.blake2b(f"{request_id}\x00{int(seed)}".encode("utf-8"),
                        digest_size=8).digest()
    return (int.from_bytes(h[:4], "little"),
            int.from_bytes(h[4:], "little"))


#: Temperature buckets for acceptance-rate attribution: greedy on its own,
#: the rest split at the 0.5 / 1.0 knees.
TEMPERATURE_BUCKETS = ("greedy", "low", "mid", "high")


def temperature_bucket(temperature: float) -> str:
    t = float(temperature)
    if t <= 0.0:
        return "greedy"
    if t <= 0.5:
        return "low"
    if t <= 1.0:
        return "mid"
    return "high"


def slot_arrays(n_slots: int):
    """Fresh host-side per-slot sampling arrays at the greedy defaults (the
    engine owns one set; a released slot resets its row)."""
    return {"temperature": np.zeros(n_slots, np.float32),
            "top_k": np.zeros(n_slots, np.int32),
            "top_p": np.ones(n_slots, np.float32),
            "key_hi": np.zeros(n_slots, np.uint32),
            "key_lo": np.zeros(n_slots, np.uint32)}


def gumbel(key_hi, key_lo, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (its default "low" mode):
    uniform floats in ``[tiny, 1)`` from the top 23 bits as a mantissa
    under exponent 0 (bitwise JAX's), then ``-log(-log(u))``. The two logs
    run in float64 and the result is rounded to fp32 once: within a few
    ulps of JAX's fp32 logs, and the same on every device and in every run
    (the CPU's vectorised fp32 ``log`` was seen to return another value for
    the same input in one process of ten). Returns fp32 ``[..., n]``."""
    bits = random_bits(key_hi, key_lo, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32,
                        device=f.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=f.device)
    u = torch.maximum(tiny, f * (one - tiny) + tiny).to(torch.float64)
    return (-torch.log(-torch.log(u))).to(torch.float32)


# ------------------------------------------------------------ the transform
def _per_row(a, dtype, shape, device):
    if isinstance(a, np.ndarray) and a.dtype.kind in "ui":
        a = a.astype(np.int64)        # uint32 keys: no uint32 tensor arithmetic
    t = torch.as_tensor(a, device=device).to(dtype)
    return t.reshape(tuple(t.shape) + (1,) * (len(shape) - t.dim())).expand(shape)


def sample_tokens(logits, counters, samp):
    """The batched sampling transform.

    ``logits [..., V]`` (any float dtype; filtered in fp32); ``counters
    [...]``: each entry the emitted token's absolute sequence position
    (prefill: ``length``; decode: ``positions + 1``; verify row ``j``:
    ``positions + j + 1``); ``samp``: the 5-tuple of per-slot values
    ``(temperature, top_k, top_p, key_hi, key_lo)``, each ``[B]`` (tensor
    or numpy), broadcast against ``counters`` for multi-token rows.
    Returns ``int32 [...]``. Rows with ``temperature <= 0`` return exactly
    the fp32 argmax (first maximum on ties)."""
    temperature, top_k, top_p, key_hi, key_lo = samp
    dev = logits.device
    logits = logits.to(torch.float32)
    vocab = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    counters = torch.as_tensor(counters, device=dev).to(torch.int64)
    shape = tuple(counters.shape)
    temperature = _per_row(temperature, torch.float32, shape, dev)
    top_k = _per_row(top_k, torch.int64, shape, dev)
    top_p = _per_row(top_p, torch.float32, shape, dev)
    key_hi = _per_row(key_hi, torch.int64, shape, dev)
    key_lo = _per_row(key_lo, torch.int64, shape, dev)

    scaled = logits / torch.clamp(temperature, min=1e-6)[..., None]
    # Top-k: keep scores >= the k-th largest; top_k <= 0 disables.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, vocab),
                        torch.clamp(top_k, 1, vocab))
    kth = torch.gather(sorted_desc, -1, (k_eff - 1)[..., None])
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    masked = torch.where(scaled >= kth, scaled, neg_inf)
    # Softmax as jax.nn.softmax spells it.
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    # Top-p over the survivors: the strict '< top_p' on the EXCLUSIVE
    # prefix sum keeps the head even when its own mass exceeds top_p.
    p_sorted = torch.sort(probs, dim=-1, descending=True).values
    prefix = torch.cumsum(p_sorted, dim=-1) - p_sorted
    keep_sorted = prefix < top_p[..., None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    thresh = torch.where(keep_sorted, p_sorted, inf).amin(dim=-1, keepdim=True)
    filtered = torch.where(probs >= thresh, masked, neg_inf)
    # Counter-keyed Gumbel-argmax: the key is a pure function of (request
    # key, absolute position).
    k_hi, k_lo = fold_in(key_hi, key_lo, counters)
    sampled = torch.argmax(filtered + gumbel(k_hi, k_lo, vocab), dim=-1)
    return torch.where(temperature <= 0.0, greedy_tok, sampled.to(torch.int32))


# -------------------------------------------------------------------- stats
def chi_square_fits(observed, expected_probs, alpha_crit: float = 3.0):
    """Pearson chi-square goodness of fit without scipy: ``(fits, stat,
    crit)``, ``crit`` the Wilson–Hilferty chi-square quantile at
    ``alpha_crit`` standard normal deviations. Bins with expected count
    under 5 are pooled into the last bin."""
    obs = np.asarray(observed, np.float64)
    exp = np.asarray(expected_probs, np.float64)
    exp = exp / exp.sum() * obs.sum()
    order = np.argsort(exp)[::-1]
    obs, exp = obs[order], exp[order]
    keep = exp >= 5.0
    if not keep.all():
        first_bad = max(int(np.argmax(~keep)), 1)
        obs = np.concatenate([obs[:first_bad], [obs[first_bad:].sum()]])
        exp = np.concatenate([exp[:first_bad], [exp[first_bad:].sum()]])
    dof = max(len(obs) - 1, 1)
    stat = float(((obs - exp) ** 2 / np.maximum(exp, 1e-12)).sum())
    z = float(alpha_crit)
    crit = dof * (1.0 - 2.0 / (9.0 * dof)
                  + z * math.sqrt(2.0 / (9.0 * dof))) ** 3
    return stat <= crit, stat, crit


def filtered_probs(logits, params: SamplingParams):
    """Host-side float64 reference of the transform's filtered distribution
    (the numpy mirror of :func:`sample_tokens`'s masks), for calibration."""
    x = np.asarray(logits, np.float64)
    if params.greedy:
        p = np.zeros_like(x)
        p[int(np.argmax(x))] = 1.0
        return p
    scaled = x / max(params.temperature, 1e-6)
    if params.top_k > 0:
        kth = np.sort(scaled)[::-1][min(params.top_k, len(scaled)) - 1]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    e = np.exp(scaled - np.max(scaled[np.isfinite(scaled)]))
    e = np.where(np.isfinite(scaled), e, 0.0)
    probs = e / e.sum()
    order = np.argsort(probs)[::-1]
    prefix = np.cumsum(probs[order]) - probs[order]
    thresh = probs[order][prefix < params.top_p].min()
    probs = np.where(probs >= thresh, probs, 0.0)
    return probs / probs.sum()


def samp_tuple(params: SamplingParams, request_id: str, n: int):
    """The 5-tuple of :func:`sample_tokens` for ``n`` rows of one request."""
    hi, lo = request_key(request_id, params.seed)
    return (np.full(n, params.temperature, np.float32),
            np.full(n, params.top_k, np.int32),
            np.full(n, params.top_p, np.float32),
            np.full(n, hi, np.uint32), np.full(n, lo, np.uint32))


# ----------------------------------------------------------------- selftest
def selftest_sampling() -> int:
    """The CPU proof of the stochastic-sampling contract; returns an exit
    code. Bars: (1) the transform is calibrated — chi-square of 4096
    counter-keyed draws against :func:`filtered_probs` for plain / top-k /
    top-p / combined params, no masked token ever drawn, and
    ``temperature=0`` rows bitwise the argmax; (2) replay — the same
    ``(request_id, seed)`` regenerates the same engine stream, another seed
    diverges; (3) lossless spec — spec streams equal plain stochastic
    streams across temperature x top_p x k for a same-weights and a
    divergent draft; (4) a prefix-cache hit equals a cold start."""
    import json
    import time

    from autodist_tpu_torch.serve.spec import SelftestRig

    t0 = time.perf_counter()
    bars = {}
    rng = np.random.default_rng(11)
    vocab, n_draws = 16, 4096
    logits_row = rng.normal(0.0, 1.5, vocab).astype(np.float32)
    calib_ok = True
    for sp in (SamplingParams(temperature=1.0),
               SamplingParams(temperature=0.7, top_k=5),
               SamplingParams(temperature=1.3, top_p=0.8),
               SamplingParams(temperature=0.9, top_k=8, top_p=0.9, seed=3)):
        toks = sample_tokens(
            torch.from_numpy(np.broadcast_to(logits_row, (n_draws, vocab)).copy()),
            torch.arange(n_draws), samp_tuple(sp, "calib", n_draws)).numpy()
        ref = filtered_probs(logits_row, sp)
        fits = chi_square_fits(np.bincount(toks, minlength=vocab),
                               np.maximum(ref, 1e-300))[0]
        calib_ok = calib_ok and fits and bool(np.all(ref[toks] > 0.0))
    glogits = rng.normal(0.0, 2.0, (8, vocab)).astype(np.float32)
    greedy = sample_tokens(torch.from_numpy(glogits), torch.arange(8),
                           samp_tuple(SamplingParams(), "g", 8)).numpy()
    bars["transform_calibrated"] = calib_ok
    bars["greedy_reduction_exact"] = bool(np.array_equal(greedy, glogits.argmax(-1)))

    rig = SelftestRig()
    prompts = [rng.integers(1, 127, size=n).astype(np.int32) for n in (5, 9, 16, 21)]
    max_new = 8
    replay_ok, seed_diverges = True, False
    for i, p in enumerate(prompts):
        sp = SamplingParams(temperature=1.0, seed=1)
        a = rig.plain.generate(p, max_new, request_id=f"replay-{i}", sampling=sp)
        replay_ok &= a == rig.plain.generate(p, max_new, request_id=f"replay-{i}",
                                             sampling=sp)
        seed_diverges |= a != rig.plain.generate(
            p, max_new, request_id=f"replay-{i}",
            sampling=SamplingParams(temperature=1.0, seed=2))
    bars["replay_bit_identical"] = replay_ok
    bars["seed_diverges"] = seed_diverges

    spec_ok = True
    for same_draft in (True, False):
        for temp, top_p, k in ((0.8, 1.0, 2), (1.0, 0.9, 3), (1.5, 0.9, 4)):
            eng = rig.spec_engine(k, same_draft=same_draft)
            sp = SamplingParams(temperature=temp, top_p=top_p, seed=5)
            for i, p in enumerate(prompts):
                rid = f"spec-{same_draft}-{temp}-{k}-{i}"
                spec_ok &= (eng.generate(p, max_new, request_id=rid, sampling=sp)
                            == rig.plain.generate(p, max_new, request_id=rid,
                                                  sampling=sp))
    bars["spec_bit_identical_to_plain"] = spec_ok

    warm = rig.engine(prefix_cache=True)
    shared = rng.integers(1, 127, size=24).astype(np.int32)
    sp = SamplingParams(temperature=1.0, top_p=0.9, seed=4)
    warm.generate(shared, max_new, request_id="warmup", sampling=sp)
    hit = warm.generate(shared, max_new, request_id="probe", sampling=sp)
    cold = rig.engine(prefix_cache=True).generate(shared, max_new,
                                                  request_id="probe", sampling=sp)
    bars["prefix_hit_vs_cold_bit_identical"] = hit == cold
    bars["prefix_hit"] = warm.prefix_stats()["hits"] > 0

    ok = all(bars.values())
    print(json.dumps({"selftest_sampling": {
        **bars, "elapsed_s": round(time.perf_counter() - t0, 1), "ok": ok}}))
    return 0 if ok else 1
