"""VGG19 feature extractor, torchvision's 'E' config (port of
lctvqa/models/vgg.py).

features -> AdaptiveAvgPool(7) -> fc6 -> ReLU -> Dropout -> fc7 -> ReLU ->
Dropout: the reference's VGG19 with its final classifier Linear removed,
a 4096-wide image feature. Conv weights are OIHW and linear weights
[in, out]; `convert_torch_state_dict` takes a torchvision `state_dict` as
it is.
"""

from __future__ import annotations

from typing import Optional

import torch

from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import cuda_vgg
from lctvqa_torch.ops import nn as N

# torchvision cfg 'E' (vgg19): conv output channels, 'M' = 2x2 max pool
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def vgg19_init(gen: torch.Generator, width_mult: float = 1.0,
               fc_dim: int = 4096):
    """Random init at torch's default conv and linear distributions.
    width_mult < 1 narrows every conv (test configs only)."""
    convs = []
    c_in = 3
    for v in VGG19_CFG:
        if v == "M":
            continue
        c_out = max(1, int(v * width_mult))
        convs.append(C.torch_conv_init(gen, 3, 3, c_in, c_out, bias=True))
        c_in = c_out
    return {
        "features": convs,
        "fc6": N.torch_linear_init(gen, c_in * 7 * 7, fc_dim),
        "fc7": N.torch_linear_init(gen, fc_dim, fc_dim),
    }


def feature_dim(params) -> int:
    return params["fc7"]["w"].shape[1]


def epilogue_route(p, x: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> bool:
    """Whether the convolution of params `p` on `x` hands its bias and
    ReLU (and the pool after it) to the `vgg_epilogue` operator: fp params
    with C a multiple of the kernel's 8 channels a thread, a compute dtype
    of bf16 or fp32 (or None), and no gradient through it, outside
    `second_order` (stage 3 takes the plain versions of every kernel).
    Every other call (a trunk being trained, int8, fp16) keeps the
    composition of `C.conv2d`, `torch.relu` and `C.max_pool`, which the
    operator's result equals bit for bit."""
    if "w_q" in p or dtype not in (None, torch.float32, torch.bfloat16):
        return False
    if p["w"].shape[0] % cuda_vgg.VEC or C.in_second_order():
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or p["w"].requires_grad or p["b"].requires_grad))


def vgg19_features(params, x: torch.Tensor,
                   gen: Optional[torch.Generator] = None,
                   deterministic: bool = True,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: NHWC normalized image -> [B, fc_dim] feature."""
    convs = iter(params["features"])
    pooled = False  # the last epilogue took the "M" that follows it
    for i, v in enumerate(VGG19_CFG):
        if v == "M":
            if not pooled:
                x = C.max_pool(x, 2, 2)
            pooled = False
            continue
        p = next(convs)
        if not epilogue_route(p, x, dtype):
            x = torch.relu(C.conv2d(p, x, stride=1, padding=1, dtype=dtype))
            continue
        # the raw convolution in the compute dtype; an output that feeds a
        # convolution in it, the last one in fp32 (the adaptive pool
        # averages what it is given)
        pooled = VGG19_CFG[i + 1:i + 2] == ("M",)
        last = i + 1 + pooled == len(VGG19_CFG)
        y = C.conv2d({"w": p["w"]}, x, stride=1, padding=1, dtype=dtype,
                     out_dtype=dtype)
        x = cuda_vgg.vgg_epilogue(y.contiguous(), p["b"], pooled,
                                  torch.float32 if last or dtype is None
                                  else dtype)
    x = C.adaptive_avg_pool(x, 7)
    # torch flattens NCHW (channel-major): keep that element order so
    # torchvision's fc6 weights line up
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = torch.relu(N.linear(params["fc6"], x, dtype=dtype))
    x = N.dropout(x, 0.5, gen, deterministic)
    x = torch.relu(N.linear(params["fc7"], x, dtype=dtype))
    return N.dropout(x, 0.5, gen, deterministic)


def convert_torch_state_dict(state_dict) -> dict:
    """torchvision vgg19 `state_dict` -> params. Conv weights are OIHW
    already; linear weights [out, in] -> [in, out]. classifier.0 -> fc6,
    classifier.3 -> fc7."""
    convs = []
    layer = 0
    for v in VGG19_CFG:
        if v == "M":
            layer += 1
            continue
        convs.append({"w": state_dict[f"features.{layer}.weight"].float(),
                      "b": state_dict[f"features.{layer}.bias"].float()})
        layer += 2  # conv + relu
    out = {"features": convs}
    for name, key in (("fc6", "classifier.0"), ("fc7", "classifier.3")):
        out[name] = {"w": state_dict[f"{key}.weight"].float().t().contiguous(),
                     "b": state_dict[f"{key}.bias"].float()}
    return out
