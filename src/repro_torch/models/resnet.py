"""INT8 ResNet-18/50 -- the paper's own evaluation models (SS V)
(counterpart of ``repro.models.resnet``).

Convolutions run as GEMMs through the PU kernels (``im2col`` +
``int8_gemm``) with power-of-two scaling, fused ReLU and fused residual
additions, exactly the PU dataflow.  The max-pool runs on the int8 map and
the average pool as a mean, then the fc product, as in the JAX package.
A float reference forward (dequantized weights) is the baseline.

Activations are single images in HWC order, as in the JAX package.  The
logits are float32, as the JAX forward's are (its docstring says int32,
but ``jnp.mean`` of int32 returns float32 and the fc product promotes):
the mean is an exact float32 sum divided by H*W, the fc product a plain
float32 ``matmul`` (never TF32).

On the card, :func:`capture_forward_int8` captures the whole int8 forward
(53 convolutions, max-pool, pool and fc at ResNet-50) at one image shape
as one CUDA graph; a call copies the image into the graph's static input
and replays it.  The JAX package does not jit this forward, so the graph
is the port's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import quantize
from repro_torch.kernels import ops
from repro_torch.kernels.common import CapturedGraph, capture_graph, resolve_device


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    relu: bool
    residual_from: Optional[str] = None   # fuse residual input tagged w/ name


def resnet_conv_specs(variant: int) -> List[ConvSpec]:
    """Per-layer conv specs, in the JAX package's order."""
    specs: List[ConvSpec] = [ConvSpec("conv1", 3, 64, 7, 2, 3, relu=True)]
    if variant == 18:
        blocks, ch_list, cin = [2, 2, 2, 2], [64, 128, 256, 512], 64
        for s_i, (nb, ch) in enumerate(zip(blocks, ch_list)):
            for b in range(nb):
                stride = 2 if (s_i > 0 and b == 0) else 1
                downsample = stride != 1 or cin != ch
                specs.append(ConvSpec(f"s{s_i}b{b}c1", cin, ch, 3, stride, 1, relu=True))
                specs.append(ConvSpec(
                    f"s{s_i}b{b}c2", ch, ch, 3, 1, 1, relu=True,
                    residual_from=(f"s{s_i}b{b}down" if downsample else "block_in"),
                ))
                if downsample:
                    specs.append(ConvSpec(f"s{s_i}b{b}down", cin, ch, 1, stride, 0, relu=False))
                cin = ch
    elif variant == 50:
        blocks, ch_list, cin = [3, 4, 6, 3], [64, 128, 256, 512], 64
        for s_i, (nb, ch) in enumerate(zip(blocks, ch_list)):
            for b in range(nb):
                stride = 2 if (s_i > 0 and b == 0) else 1
                downsample = stride != 1 or cin != ch * 4
                specs.append(ConvSpec(f"s{s_i}b{b}c1", cin, ch, 1, 1, 0, relu=True))
                specs.append(ConvSpec(f"s{s_i}b{b}c2", ch, ch, 3, stride, 1, relu=True))
                specs.append(ConvSpec(
                    f"s{s_i}b{b}c3", ch, ch * 4, 1, 1, 0, relu=True,
                    residual_from=(f"s{s_i}b{b}down" if downsample else "block_in"),
                ))
                if downsample:
                    specs.append(ConvSpec(f"s{s_i}b{b}down", cin, ch * 4, 1, stride, 0, relu=False))
                cin = ch * 4
    else:
        raise ValueError(variant)
    return specs


def feature_dim(variant: int) -> int:
    return 512 if variant == 18 else 2048


def init_params(variant: int, seed: int = 0, device=None, num_classes: int = 1000) -> dict:
    """Seeded random quantized parameters, the recipe of the JAX
    ``init_params`` (``resnet.py:82-108``) with a ``torch.Generator`` in
    place of ``jax.random``: conv weights ``normal * sqrt(2/fan_in)``,
    quantized; bias zeros; ``shift = -exp``; fc ``normal * sqrt(1/feat)``.
    Drawn on the CPU, so a seed gives the same weights on every device,
    then moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, dict] = {}

    def layer(shape, var, n_out):
        wq = quantize(torch.randn(shape, generator=gen) * math.sqrt(var))
        return {"w": wq.to(dev), "bias": torch.zeros(n_out, dtype=torch.int32, device=dev),
                "shift": (-wq.exp).to(dev)}

    for spec in resnet_conv_specs(variant):
        fan_in = spec.k * spec.k * spec.cin
        params[spec.name] = layer((spec.k, spec.k, spec.cin, spec.cout), 2.0 / fan_in, spec.cout)
    feat = feature_dim(variant)
    params["fc"] = layer((feat, num_classes), 1.0 / feat, num_classes)
    return params


def _maxpool_int8(x: torch.Tensor, k: int = 3, s: int = 2, p: int = 1) -> torch.Tensor:
    """k x k / stride s max-pool of an (H, W, C) int8 map padded with -128,
    as the max of k*k strided views."""
    xp = F.pad(x, (0, 0, p, p, p, p), value=-128)
    h, w = xp.shape[0], xp.shape[1]
    oh, ow = (h - k) // s + 1, (w - k) // s + 1
    out = None
    for i in range(k):
        for j in range(k):
            v = xp[i: i + (oh - 1) * s + 1: s, j: j + (ow - 1) * s + 1: s]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _apply_conv(params, spec: ConvSpec, x, residual):
    p = params[spec.name]
    return ops.conv2d_int8(
        x, p["w"].q, p["bias"], k=spec.k, stride=spec.stride, pad=spec.pad,
        shift=p["shift"], relu=spec.relu, residual=residual,
    )


def _walk(specs: List[ConvSpec], x, block_in, conv):
    """The residual graph of the JAX forward: each block's last conv takes
    its residual from the block input or from the block's downsample conv,
    which runs only then (its own place in the spec list is skipped)."""
    by_name = {s.name: s for s in specs}
    for spec in specs[1:]:
        if spec.residual_from is None and spec.name.endswith("down"):
            continue
        if spec.residual_from is None:
            x = conv(spec, x, None)
            continue
        if spec.residual_from != "block_in":
            res = conv(by_name[spec.residual_from], block_in, None)
        else:
            res = block_in
        x = conv(spec, x, res)
        block_in = x
    return x


def _trunk_int8(variant: int, params: dict, img: torch.Tensor) -> torch.Tensor:
    """The int8 conv trunk: conv1, max-pool and every block -> the last
    (H', W', C) int8 feature map."""
    specs = resnet_conv_specs(variant)
    x = _apply_conv(params, specs[0], img, None)
    x = _maxpool_int8(x)
    return _walk(specs, x, x, lambda spec, x, res: _apply_conv(params, spec, x, res))


def forward_int8(variant: int, params: dict, img: torch.Tensor) -> torch.Tensor:
    """Single-image INT8 inference: img (H, W, 3) int8 -> (num_classes,)
    float32 logits on the activation x weight grid."""
    return _head(params, _trunk_int8(variant, params, img))


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Global average pool (paper: a conv layer; a mean here, as the JAX
    forward: the float32 sum of int8 values is exact) and the fc."""
    feat = x.to(torch.float32).sum(dim=(0, 1)) / float(x.shape[0] * x.shape[1])
    fc = params["fc"]
    return feat @ fc["w"].q.to(torch.float32) + fc["bias"].to(torch.float32)


@dataclasses.dataclass(eq=False)
class CapturedForward:
    """:func:`forward_int8` as one CUDA graph over static tensors: the
    input ``image``, and the ``trunk`` and ``logits`` that every call
    overwrites.  The graph reads the parameters where they lie, so
    weights rewritten in place (an NIU round) take effect at the next
    call."""
    graph: CapturedGraph
    image: torch.Tensor
    trunk: torch.Tensor
    logits: torch.Tensor

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """The logits of ``img`` (a copy: the next call overwrites the
        graph's)."""
        self.image.copy_(img)
        self.graph.replay()
        return self.logits.clone()


def capture_forward_int8(variant: int, params: dict, image_shape) -> CapturedForward:
    """Capture the int8 forward of ``variant`` at ``image_shape`` (H, W, 3)
    on the parameters' card: one eager forward (on a zero image) builds
    and configures the kernels and their scratch, then the capture.  Only
    the card has CUDA graphs: on the CPU, call :func:`forward_int8`."""
    dev = params["fc"]["w"].q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA graphs need parameters on the card, not on {dev}")
    image = torch.zeros(tuple(image_shape), dtype=torch.int8, device=dev)

    def forward():
        trunk = _trunk_int8(variant, params, image)
        return trunk, _head(params, trunk)

    graph, (trunk, logits) = capture_graph(forward)
    return CapturedForward(graph, image, trunk, logits)


def forward_float(variant: int, params: dict, img: torch.Tensor) -> torch.Tensor:
    """Float reference with dequantized weights (baseline for AIMC studies):
    img (H, W, 3) -> (num_classes,) float32.  Convolutions in float32
    through ``F.conv2d``, with TF32 off."""
    specs = resnet_conv_specs(variant)

    def conv(spec: ConvSpec, x, residual):
        w = params[spec.name]["w"].dequantize().permute(3, 2, 0, 1)     # OIHW
        y = F.conv2d(x, w, stride=spec.stride, padding=spec.pad)
        if residual is not None:
            y = y + residual
        return F.relu(y) if spec.relu else y

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        x = conv(specs[0], img.to(torch.float32).permute(2, 0, 1)[None], None)   # NCHW
        x = F.max_pool2d(x, 3, 2, 1)        # pads with -inf, as the JAX forward
        x = _walk(specs, x, x, conv)
    feat = x[0].mean(dim=(1, 2))
    return feat @ params["fc"]["w"].dequantize()
