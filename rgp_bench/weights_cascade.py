"""Seeded weights of the two-level ConvGRU cascade (`gaze_grcn_cascade`),
made on the run's device in one draw, as `weights.head` makes the other
heads'.

Every parameter of the program's state dict is drawn under its name (the
reference release's variable names), the frozen ShallowNet's included:
N(0, std) per leaf, the std the configuration's `init` gives for the
leaf's part (listed there under `assumed`):

    c3d_proj.*        proj_std      the 1024 -> 512 projection
    bottom_cell.*     bottom_std    3x3 ConvGRU, 256 units, at 7x7
    up_w              up_std        11x11 stride-7 deconvolution
    top_cell.*        top_std       5x5 ConvGRU, 3 units, at 49x49
    fc1_*, fc2_*      fc1_std, fc2_std, fc_b_std (biases)
    shallownet.*      shallownet_std (frozen; feeds nothing)
"""

from __future__ import annotations

import math

import torch

from rgp_bench import weights

SHALLOWNET = {"conv1_w": (5, 5, 3, 32), "conv1_b": (32,),
              "conv2_w": (3, 3, 32, 64), "conv2_b": (64,),
              "conv3_w": (3, 3, 64, 32), "conv3_b": (32,),
              "fc1_w": (11 * 11 * 32, 4802), "fc1_b": (4802,),
              "fc2_w": (2401, 4802), "fc2_b": (4802,)}


def shapes(cfg: dict) -> dict:
    """{name: (shape, std)} of the cascade's parameters under the
    program's state-dict names."""
    m, init, c = cfg["model"], cfg["init"], cfg["cascade"]
    f, p = m["dim_feature"], m["dim_cnn_proj"]
    if (m["gazemap_height"], m["gazemap_width"]) != (49, 49):
        raise ValueError("the cascade's head gives 49x49 maps")
    u, kb = c["bottom_units"], c["bottom_kernel"]
    up, tu, kt = c["up_channels"], c["top_units"], c["top_kernel"]
    fc = c["fc_width"]
    out = {"c3d_proj.proj_c3d_W": ((f, p), init["proj_std"]),
           "c3d_proj.proj_c3d_b": ((p,), init["proj_std"])}
    for cell, cin, units, k, std in (("bottom_cell", p, u, kb, "bottom_std"),
                                     ("top_cell", up, tu, kt, "top_std")):
        for gate in ("_z", "_r", ""):
            out[f"{cell}.W{gate}"] = ((k, k, cin, units), init[std])
            out[f"{cell}.U{gate}"] = ((k, k, units, units), init[std])
    ku = c["up_kernel"]
    out["up_w"] = ((ku, ku, u, up), init["up_std"])
    out["fc1_w"] = ((49 * 49 * tu, fc), init["fc1_std"])
    out["fc1_b"] = ((fc,), init["fc_b_std"])
    out["fc2_w"] = ((fc // 2, fc), init["fc2_std"])
    out["fc2_b"] = ((fc,), init["fc_b_std"])
    for name, shape in SHALLOWNET.items():
        out[f"shallownet.{name}"] = (shape, init["shallownet_std"])
    return out


def frozen(name: str) -> bool:
    """Whether the optimizer leaves the parameter `name` as it is."""
    return name.split(".")[0] == "shallownet"


def params(cfg: dict, seed: int, device) -> dict:
    """The cascade's f32 parameters by name, in `shapes`' order."""
    table = shapes(cfg)
    total = sum(math.prod(s) for s, _ in table.values())
    flat = torch.randn(total, generator=weights.generator(seed, "cascade",
                                                          device),
                       device=device)
    out, at = {}, 0
    for name, (shape, std) in table.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out
