"""Inception-V3 of the PyTorch port.

Mirrors the JAX package's ``models/inception.py``: the stem, 3x InceptionA,
ReductionA, 4x InceptionB, ReductionB, 2x InceptionC, a global average pool
and the head (no auxiliary classifier), every conv followed by BatchNorm and
ReLU, SAME padding throughout, ``width`` scaling every channel count by a
multiple of 1/16. bf16 compute by default, fp32 params, statistics and
logits.

Every 1x1 conv + BatchNorm pair runs as the fused product + statistics op
(``layers.conv_batchnorm`` → ``ops/fused_conv_stats.py``, the CUDA kernel on
the card): stem3, the 1x1 heads of every mixed block's branches, of
ReductionA and ReductionB, and the ``bpool`` branches after their average
pool, 40 launches a forward. The 3x3,
1x7, 7x1, 5x5, 1x3 and 3x1 convs stay ``F.conv2d`` + BatchNorm. As in
ResNet, the fused convs' statistics come from the fp32 product before its
rounding to bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import (ModelSpec, image_example_batch,
                                            register_model, seeded_generator)

# approx fwd FLOPs per 299x299 image (2·MACs; the JAX package's figure)
_FWD_FLOPS = 5.7e9


def _conv_bn_init(gen, kh, kw, cin, cout, dev):
    return {**L.conv_init(gen, kh, kw, cin, cout, device=dev),
            "bn": L.batchnorm_init(cout, device=dev)}


def _conv_bn(p, x, stride=1, dtype=torch.bfloat16):
    y = L.conv_batchnorm(p, p["bn"], x, stride, compute_dtype=dtype)
    return torch.relu(y).to(dtype)


# Branch tables: (name, [(kh, kw, cin, cout), ...]) conv chains in pre-scale
# channels; the V3 paper's channel plan (Szegedy et al. 2015, table 1).
def _inception_a_spec(cin, pool_ch):
    return [("b1x1", [(1, 1, cin, 64)]),
            ("b5x5", [(1, 1, cin, 48), (5, 5, 48, 64)]),
            ("b3x3dbl", [(1, 1, cin, 64), (3, 3, 64, 96), (3, 3, 96, 96)]),
            ("bpool", [(1, 1, cin, pool_ch)])]


def _reduction_a_spec(cin):
    return [("b3x3", [(3, 3, cin, 384)]),
            ("b3x3dbl", [(1, 1, cin, 64), (3, 3, 64, 96), (3, 3, 96, 96)])]


def _inception_b_spec(cin, c7):
    return [("b1x1", [(1, 1, cin, 192)]),
            ("b7x7", [(1, 1, cin, c7), (1, 7, c7, c7), (7, 1, c7, 192)]),
            ("b7x7dbl", [(1, 1, cin, c7), (7, 1, c7, c7), (1, 7, c7, c7),
                         (7, 1, c7, c7), (1, 7, c7, 192)]),
            ("bpool", [(1, 1, cin, 192)])]


def _reduction_b_spec(cin):
    return [("b3x3", [(1, 1, cin, 192), (3, 3, 192, 320)]),
            ("b7x7x3", [(1, 1, cin, 192), (1, 7, 192, 192), (7, 1, 192, 192),
                        (3, 3, 192, 192)])]


def _inception_c_spec(cin):
    return [("b1x1", [(1, 1, cin, 320)]),
            ("b3x3", [(1, 1, cin, 384)]),
            ("b3x3_a", [(1, 3, 384, 384)]),
            ("b3x3_b", [(3, 1, 384, 384)]),
            ("b3x3dbl", [(1, 1, cin, 448), (3, 3, 448, 384)]),
            ("b3x3dbl_a", [(1, 3, 384, 384)]),
            ("b3x3dbl_b", [(3, 1, 384, 384)]),
            ("bpool", [(1, 1, cin, 192)])]


def _branch_init(gen, specs, w, dev):
    return {f"{name}_{i}": _conv_bn_init(gen, kh, kw, w(cin), w(cout), dev)
            for name, chain in specs for i, (kh, kw, cin, cout) in enumerate(chain)}


def _chain(params, name, n, x, dtype, strides=None):
    for i in range(n):
        x = _conv_bn(params[f"{name}_{i}"], x, stride=strides[i] if strides else 1,
                     dtype=dtype)
    return x


def _inception_a(p, x, dtype):
    return torch.cat([_chain(p, "b1x1", 1, x, dtype), _chain(p, "b5x5", 2, x, dtype),
                      _chain(p, "b3x3dbl", 3, x, dtype),
                      _chain(p, "bpool", 1, L.avg_pool(x, 3, 1), dtype)], dim=-1)


def _reduction_a(p, x, dtype):
    return torch.cat([_chain(p, "b3x3", 1, x, dtype, strides=[2]),
                      _chain(p, "b3x3dbl", 3, x, dtype, strides=[1, 1, 2]),
                      L.max_pool(x, 3, 2)], dim=-1)


def _inception_b(p, x, dtype):
    return torch.cat([_chain(p, "b1x1", 1, x, dtype), _chain(p, "b7x7", 3, x, dtype),
                      _chain(p, "b7x7dbl", 5, x, dtype),
                      _chain(p, "bpool", 1, L.avg_pool(x, 3, 1), dtype)], dim=-1)


def _reduction_b(p, x, dtype):
    return torch.cat([_chain(p, "b3x3", 2, x, dtype, strides=[1, 2]),
                      _chain(p, "b7x7x3", 4, x, dtype, strides=[1, 1, 1, 2]),
                      L.max_pool(x, 3, 2)], dim=-1)


def _inception_c(p, x, dtype):
    y3 = _chain(p, "b3x3", 1, x, dtype)
    ydbl = _chain(p, "b3x3dbl", 2, x, dtype)
    return torch.cat([_chain(p, "b1x1", 1, x, dtype), _chain(p, "b3x3_a", 1, y3, dtype),
                      _chain(p, "b3x3_b", 1, y3, dtype),
                      _chain(p, "b3x3dbl_a", 1, ydbl, dtype),
                      _chain(p, "b3x3dbl_b", 1, ydbl, dtype),
                      _chain(p, "bpool", 1, L.avg_pool(x, 3, 1), dtype)], dim=-1)


def init_params(seed: int, num_classes: int, width: float = 1.0,
                device=None) -> Dict[str, Any]:
    """``width`` scales every channel count exactly (any multiple of 1/16);
    the bookkeeping of ``cin`` stays in pre-scale channels, as in JAX."""
    def w(c: int) -> int:
        v = c * width
        if v != int(v) or v < 1:
            raise ValueError(f"width={width} does not scale channel count {c} to a "
                             "positive integer; use a multiple of 1/16")
        return int(v)

    gen, dev = seeded_generator(seed, device)
    params: Dict[str, Any] = {
        "stem0": _conv_bn_init(gen, 3, 3, 3, w(32), dev),
        "stem1": _conv_bn_init(gen, 3, 3, w(32), w(32), dev),
        "stem2": _conv_bn_init(gen, 3, 3, w(32), w(64), dev),
        "stem3": _conv_bn_init(gen, 1, 1, w(64), w(80), dev),
        "stem4": _conv_bn_init(gen, 3, 3, w(80), w(192), dev),
    }
    cin = 192
    for i, pool_ch in enumerate([32, 64, 64]):
        params[f"mixed_a{i}"] = _branch_init(gen, _inception_a_spec(cin, pool_ch), w, dev)
        cin = 64 + 64 + 96 + pool_ch
    params["reduction_a"] = _branch_init(gen, _reduction_a_spec(cin), w, dev)
    cin = 384 + 96 + cin
    for i, c7 in enumerate([128, 160, 160, 192]):
        params[f"mixed_b{i}"] = _branch_init(gen, _inception_b_spec(cin, c7), w, dev)
        cin = 768
    params["reduction_b"] = _branch_init(gen, _reduction_b_spec(cin), w, dev)
    cin = 320 + 192 + cin
    for i in range(2):
        params[f"mixed_c{i}"] = _branch_init(gen, _inception_c_spec(cin), w, dev)
        cin = 2048
    params["head"] = L.dense_init(gen, w(2048), num_classes, device=dev)
    return params


def forward(params, images, dtype=torch.bfloat16):
    """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
    x = images.to(dtype)
    x = _conv_bn(params["stem0"], x, stride=2, dtype=dtype)
    x = _conv_bn(params["stem1"], x, dtype=dtype)
    x = _conv_bn(params["stem2"], x, dtype=dtype)
    x = L.max_pool(x, 3, 2)
    x = _conv_bn(params["stem3"], x, dtype=dtype)
    x = _conv_bn(params["stem4"], x, dtype=dtype)
    x = L.max_pool(x, 3, 2)
    for i in range(3):
        x = _inception_a(params[f"mixed_a{i}"], x, dtype)
    x = _reduction_a(params["reduction_a"], x, dtype)
    for i in range(4):
        x = _inception_b(params[f"mixed_b{i}"], x, dtype)
    x = _reduction_b(params["reduction_b"], x, dtype)
    for i in range(2):
        x = _inception_c(params[f"mixed_c{i}"], x, dtype)
    x = x.mean(dim=(1, 2))
    return L.dense(params["head"], x, compute_dtype=dtype).to(torch.float32)


@register_model("inception")
def inception(num_classes: int = 1000, image_size: int = 299,
              width: float = 1.0) -> ModelSpec:
    """``width`` < 1 shrinks every channel count (a multiple of 1/16)."""
    def loss_fn(params, batch):
        return L.softmax_xent(forward(params, batch["images"]), batch["labels"])

    return ModelSpec(
        name="inception_v3",
        init=lambda seed=0, device=None: init_params(seed, num_classes, width,
                                                     device=device),
        loss_fn=loss_fn,
        example_batch=image_example_batch(image_size, num_classes),
        apply=lambda p, images: forward(p, images),
        flops_per_example=3 * _FWD_FLOPS * (image_size / 299.0) ** 2 * width ** 2,
    )
