"""DenseNet image classifiers of the PyTorch port.

Mirrors the JAX package's ``models/densenet.py``: depths 121/169/201 (or
``blocks`` / ``growth`` overrides), the space-to-depth stem with BatchNorm,
ReLU and a 3x3/s2 max pool, dense blocks whose layers run BN → ReLU → 1x1
conv (4·growth channels) → BN → ReLU → 3x3 conv (growth channels) and
concatenate their output to their input, transitions BN → ReLU → 1x1 conv
(half the channels) → 2x2/s2 average pool, then BN, ReLU, a global average
pool and the head. bf16 compute by default, fp32 params, BatchNorm
statistics and logits.

Each dense layer's 1x1 ``conv1`` and the ``bn2`` that follows it run as the
fused product + statistics op (``layers.conv_batchnorm`` →
``ops/fused_conv_stats.py``, the CUDA kernel on the card): one launch a
layer, 58 a DenseNet-121 forward. Its input width ``K = 2·growth +
i·growth`` grows by 32 a layer at the default growth, so many of its K are
not multiples of 64. A transition's 1x1 conv follows its BatchNorm instead
of feeding one, so it stays an ``F.conv2d``. As in ResNet, the fused convs'
statistics come from the fp32 product before its rounding to bf16.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import (ModelSpec, image_example_batch,
                                            register_model, seeded_generator)

# depth -> layers per dense block (growth rate 32, compression 0.5)
_CFG = {121: [6, 12, 24, 16], 169: [6, 12, 32, 32], 201: [6, 12, 48, 32]}
_GROWTH = 32


def _blocks(depth: int, blocks: Optional[Sequence[int]]) -> Sequence[int]:
    if blocks is None and depth not in _CFG:
        raise ValueError(f"unsupported densenet depth {depth}; valid: {sorted(_CFG)}")
    return blocks or _CFG[depth]


def _fwd_flops(blocks, growth, image_size, num_classes) -> float:
    """Analytic forward FLOPs (2·MACs of the convs and the head), the JAX
    package's formula."""
    sp = image_size // 2
    f = 2 * 7 * 7 * 3 * 2 * growth * sp * sp
    sp //= 2
    cin = 2 * growth
    for bi, n in enumerate(blocks):
        for _ in range(n):
            f += 2 * cin * 4 * growth * sp * sp
            f += 2 * 9 * 4 * growth * growth * sp * sp
            cin += growth
        if bi < len(blocks) - 1:
            f += 2 * cin * (cin // 2) * sp * sp
            cin //= 2
            sp //= 2
    return float(f + 2 * cin * num_classes)


def init_params(seed: int, depth: int, num_classes: int, blocks=None,
                growth: int = _GROWTH, device=None) -> Dict[str, Any]:
    blocks = _blocks(depth, blocks)
    gen, dev = seeded_generator(seed, device)
    params: Dict[str, Any] = {
        "stem": {**L.conv_init(gen, 7, 7, 3, 2 * growth, device=dev),
                 "bn": L.batchnorm_init(2 * growth, device=dev)},
    }
    cin = 2 * growth
    for bi, n in enumerate(blocks):
        for li in range(n):
            params[f"block{bi}_layer{li}"] = {
                "bn1": L.batchnorm_init(cin, device=dev),
                "conv1": L.conv_init(gen, 1, 1, cin, 4 * growth, device=dev),
                "bn2": L.batchnorm_init(4 * growth, device=dev),
                "conv2": L.conv_init(gen, 3, 3, 4 * growth, growth, device=dev),
            }
            cin += growth
        if bi < len(blocks) - 1:
            params[f"transition{bi}"] = {
                "bn": L.batchnorm_init(cin, device=dev),
                "conv": L.conv_init(gen, 1, 1, cin, cin // 2, device=dev),
            }
            cin //= 2
    params["final_bn"] = L.batchnorm_init(cin, device=dev)
    params["head"] = L.dense_init(gen, cin, num_classes, device=dev)
    return params


def _dense_layer(p, x, dtype):
    y = torch.relu(L.batchnorm(p["bn1"], x))
    y = torch.relu(L.conv_batchnorm(p["conv1"], p["bn2"], y, compute_dtype=dtype))
    y = L.conv(p["conv2"], y, compute_dtype=dtype)
    return torch.cat([x, y.to(x.dtype)], dim=-1)    # the dense connectivity


def forward(params, images, depth: int, dtype=torch.bfloat16, blocks=None):
    """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
    blocks = _blocks(depth, blocks)
    x = images.to(dtype)
    if images.shape[1] % 2 == 0 and images.shape[2] % 2 == 0:
        x = L.space_to_depth_stem(params["stem"], x, dtype)
    else:
        x = L.conv(params["stem"], x, stride=2, compute_dtype=dtype)
    x = torch.relu(L.batchnorm(params["stem"]["bn"], x))
    x = L.max_pool(x, 3, 2)
    for bi, n in enumerate(blocks):
        for li in range(n):
            x = _dense_layer(params[f"block{bi}_layer{li}"], x, dtype)
        if bi < len(blocks) - 1:
            t = params[f"transition{bi}"]
            x = torch.relu(L.batchnorm(t["bn"], x))
            x = L.conv(t["conv"], x, compute_dtype=dtype)
            x = L.avg_pool(x, 2, 2)
    x = torch.relu(L.batchnorm(params["final_bn"], x))
    x = x.mean(dim=(1, 2))
    return L.dense(params["head"], x, compute_dtype=dtype).to(torch.float32)


@register_model("densenet")
def densenet(depth: int = 121, num_classes: int = 1000, image_size: int = 224,
             blocks=None, growth: int = _GROWTH) -> ModelSpec:
    """``blocks`` / ``growth`` override the depth table."""
    _blocks(depth, blocks)

    def loss_fn(params, batch):
        logits = forward(params, batch["images"], depth, blocks=blocks)
        return L.softmax_xent(logits, batch["labels"])

    return ModelSpec(
        name=f"densenet{depth}",
        init=lambda seed=0, device=None: init_params(seed, depth, num_classes, blocks,
                                                     growth, device=device),
        loss_fn=loss_fn,
        example_batch=image_example_batch(image_size, num_classes),
        apply=lambda p, images: forward(p, images, depth, blocks=blocks),
        flops_per_example=3 * _fwd_flops(_blocks(depth, blocks), growth, image_size,
                                         num_classes),
    )
