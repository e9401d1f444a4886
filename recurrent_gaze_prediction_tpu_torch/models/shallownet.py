"""ShallowNet, the shallow saliency ConvNet of Pan et al. (CVPR 2016): the
port's counterpart of the JAX package's `models/shallownet.py`.

    98x98x3 -> conv 5x5x32 VALID + relu -> maxpool 2/2 SAME      (94 -> 47)
            -> conv 3x3x64 VALID + relu -> maxpool 3/2 SAME      (45 -> 23)
            -> conv 3x3x32 VALID + relu -> maxpool 3/2 SAME      (21 -> 11)
            -> fc 4802 + relu (+ dropout) -> maxout/2 -> 2401
            -> fc 4802 + relu            -> maxout/2 -> 2401
            -> reshape [49, 49]

Xavier-uniform weights, zero biases, in the JAX package's layouts (HWIO
convs, [in, out] fc) and names, so `bridge.py` carries them across as they
are. Pool3's output is flattened in (h, w, c) order before fc1, as there:
the convs return NHWC, so fc1's rows follow the JAX package's order.

Functions over a dict of tensors: the gaze models hold it as an
`nn.ParameterDict` named `shallownet`; standalone pretraining
(`train/saliency.py`) holds it as a plain dict.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import initializers as init
from ..ops.layers import conv2d, dropout, linear, max_pool2d, maxout2

FC_WIDTH = 4802          # maxout halves this to 2401 = 49 * 49

# variant geometries:
#   default -- saliency_shallownet.py:92-216 (32/64/32 convs, fc 4802, 49x49)
#   7x7     -- 7x7shallownet.py:96-195 (64/128/128 convs, fc 98, 7x7 output)
VARIANTS = {
    "default": dict(widths=(32, 64, 32), fc_width=FC_WIDTH, out_hw=(49, 49)),
    "7x7": dict(widths=(64, 128, 128), fc_width=98, out_hw=(7, 7)),
}
BN_EPS = 1e-3


def init_params(variant: str = "default", batch_norm: bool = False, *,
                generator: Optional[torch.Generator] = None) -> dict:
    """`batch_norm=True` adds the BN scale/offset pairs of the
    `saliency_shallownet_nobatch.py` variant (BN after conv1/2/3 and
    fc1/2)."""
    geo = VARIANTS[variant]
    w1, w2, w3 = geo["widths"]
    fc_width = geo["fc_width"]
    g = generator
    params = {
        "conv1_w": init.xavier_uniform((5, 5, 3, w1), generator=g),
        "conv1_b": init.zeros((w1,)),
        "conv2_w": init.xavier_uniform((3, 3, w1, w2), generator=g),
        "conv2_b": init.zeros((w2,)),
        "conv3_w": init.xavier_uniform((3, 3, w2, w3), generator=g),
        "conv3_b": init.zeros((w3,)),
        "fc1_w": init.xavier_uniform((11 * 11 * w3, fc_width), generator=g),
        "fc1_b": init.zeros((fc_width,)),
        "fc2_w": init.xavier_uniform((fc_width // 2, fc_width), generator=g),
        "fc2_b": init.zeros((fc_width,)),
    }
    if batch_norm:
        for name, dim in (("bn1", w1), ("bn2", w2), ("bn3", w3),
                          ("bn_fc1", fc_width), ("bn_fc2", fc_width)):
            params[f"{name}_scale"] = torch.ones((dim,))
            params[f"{name}_offset"] = torch.zeros((dim,))
    return params


def _batch_norm(x: torch.Tensor, params, name: str) -> torch.Tensor:
    """BN on the current batch's statistics (population variance, eps
    1e-3) with a learnable scale/offset, where the params have them (the
    nobatch variant's tflearn BN never wired its moving averages,
    `gaze_rnn.py:427`)."""
    if f"{name}_scale" not in params:
        return x
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    norm = (x - mean) * torch.rsqrt(var + BN_EPS)
    return norm * params[f"{name}_scale"] + params[f"{name}_offset"]


def _conv_block(x, params, i: int, window: int, compute_dtype):
    x = conv2d(x, params[f"conv{i}_w"], padding="VALID",
               compute_dtype=compute_dtype) + params[f"conv{i}_b"]
    x = torch.relu(_batch_norm(x, params, f"bn{i}"))
    return max_pool2d(x, window, 2, "SAME")


def apply(params, images: torch.Tensor, *, dropout_keep_prob: float = 1.0,
          generator: Optional[torch.Generator] = None, train: bool = False,
          compute_dtype=None) -> torch.Tensor:
    """images [B, 98, 98, 3] -> saliency [B, 49, 49] (or [B, 7, 7] for the
    7x7 variant).

    Dropout (keep 0.4 in the reference's standalone training,
    `saliency_shallownet.py:330`) applies after fc1's relu only, and is
    off inside the gaze models (`models/gaze_rnn.py:256-260`)."""
    if images.dim() != 4:
        raise ValueError(f"images must be [B, H, W, 3], got "
                         f"{tuple(images.shape)}")
    out_cells = params["fc2_b"].shape[-1] // 2  # the bias is never split
    out_hw = {2401: (49, 49), 49: (7, 7)}[out_cells]
    x = _conv_block(images, params, 1, 2, compute_dtype)
    x = _conv_block(x, params, 2, 3, compute_dtype)
    x = _conv_block(x, params, 3, 3, compute_dtype)
    x = x.reshape(x.shape[0], -1)                       # (h, w, c) order
    x = linear(x, params["fc1_w"], params["fc1_b"],
               compute_dtype=compute_dtype)
    x = torch.relu(_batch_norm(x, params, "bn_fc1"))
    x = dropout(x, dropout_keep_prob, generator, deterministic=not train)
    x = maxout2(x)
    x = linear(x, params["fc2_w"], params["fc2_b"],
               compute_dtype=compute_dtype)
    x = torch.relu(_batch_norm(x, params, "bn_fc2"))
    return maxout2(x).reshape(-1, *out_hw)


def l2_regularizer(params) -> torch.Tensor:
    """1e-7 * sum of l2_loss over the model's variables
    (`saliency_shallownet.py:247`); tf.nn.l2_loss = sum(x^2)/2."""
    return 1e-7 * sum(0.5 * p.float().square().sum()
                      for p in params.values())
