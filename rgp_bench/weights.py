"""Seeded weights and inputs, made on the run's device in a few large calls.

Every draw comes from a `torch.Generator` on the device seeded with
`sub_seed(seed, tag)`, so one `--seed` gives the same weights and inputs
to the program and to the plain reference, and the benchmark can make
them again after the window instead of keeping a copy.

The weights' names and shapes are the published model's (the reference
release's variable names, which the program's parameters keep); the scales
are the benchmark's own (the configuration's `init`, listed there under
`assumed`).
"""

from __future__ import annotations

import hashlib
import math

import torch

TOWER_NAMES = ("conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b",
               "conv5a", "conv5b")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draws named `tag` of run seed `seed` (any
    whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _split(flat: torch.Tensor, shapes: dict) -> dict:
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def tower_shapes(cfg: dict) -> dict:
    """{conv<i>_w: [Cout, Cin, 3, 3, 3], conv<i>_b: [Cout]} of the C3D
    tower to conv5b, Caffe's layouts."""
    shapes, cin = {}, 3
    for name, cout in zip(TOWER_NAMES, cfg["c3d"]["channels"]):
        shapes[f"{name}_w"] = (cout, cin, 3, 3, 3)
        shapes[f"{name}_b"] = (cout,)
        cin = cout
    return shapes


def tower(cfg: dict, seed: int, device) -> dict:
    """The tower's f32 weights: w ~ N(0, 1) / sqrt(27 Cin) (activations
    neither vanish nor grow through the eight layers) and b ~ N(0,
    init.tower_b_std)."""
    shapes = tower_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, "tower", device),
                       device=device)
    params = _split(flat, shapes)
    for name, t in params.items():
        if name.endswith("_w"):
            t.mul_(1.0 / math.sqrt(27.0 * t.shape[1]))
        else:
            t.mul_(cfg["init"]["tower_b_std"])
    return params


def head_shapes(cfg: dict) -> dict:
    """{name: (shape, std)} of the gaze model's parameters under the
    program's state-dict names; std None marks a constant (the frozen batch
    norm's scale 1 and offset 0)."""
    m, init = cfg["model"], cfg["init"]
    f, p, u = m["dim_feature"], m["dim_cnn_proj"], m["rnn_state_size"]
    gh, gw = m["gazemap_height"], m["gazemap_width"]
    if (gh, gw) != (49, 49):
        raise ValueError("the benchmark's head is the 49x49 deconv decoder")
    shapes = {"c3d_proj.proj_c3d_W": ((f, p), init["proj_std"]),
              "c3d_proj.proj_c3d_b": ((p,), init["proj_std"])}
    if cfg["cell"] == "convgru":
        for gate in ("z", "r", ""):
            sep = "_" if gate else ""
            shapes[f"cell.W{sep}{gate}"] = ((3, 3, p, u), init["cell_std"])
            shapes[f"cell.U{sep}{gate}"] = ((3, 3, u, u), init["cell_std"])
    elif cfg["cell"] == "convlstm":
        for gate in "ifco":
            shapes[f"cell.W_x{gate}"] = ((3, 3, p, u), init["cell_std"])
            shapes[f"cell.W_h{gate}"] = ((3, 3, u, u), init["cell_std"])
            if gate != "c":
                shapes[f"cell.W_c{gate}"] = ((7, 7, u), init["cell_std"])
    else:
        raise ValueError(f"unknown cell {cfg['cell']!r}")

    def xavier(shape):  # Glorot's normal std, TensorFlow's fans
        rf = math.prod(shape[:-2])
        return math.sqrt(2.0 / (rf * (shape[-2] + shape[-1])))

    for name, shape in (("up1_w", (5, 5, u, 64)), ("up2_w", (5, 5, 64, 32)),
                        ("up3_w", (7, 7, 32, 12))):
        shapes[f"decoder.{name}"] = (shape, xavier(shape))
    shapes["decoder.out_W"] = ((12, 1), init["head_std"])
    shapes["decoder.out_b"] = ((1,), init["head_std"])
    shapes["decoder.bn_scale"] = ((u,), None)
    shapes["decoder.bn_offset"] = ((u,), None)
    return shapes


def head(cfg: dict, seed: int, device) -> dict:
    """The gaze model's f32 parameters by name: N(0, std) per leaf from one
    draw, the batch norm's scale 1 and offset 0."""
    shapes = head_shapes(cfg)
    drawn = {n: s for n, (s, std) in shapes.items() if std is not None}
    total = sum(math.prod(s) for s in drawn.values())
    flat = torch.randn(total, generator=generator(seed, "head", device),
                       device=device)
    params = _split(flat, drawn)
    out = {}
    for name, (shape, std) in shapes.items():
        if std is None:
            fill = 1.0 if name.endswith("bn_scale") else 0.0
            out[name] = torch.full(shape, fill, device=device)
        else:
            out[name] = params[name].mul_(std)
    return out


def videos(seed: int, tag: str, shape: tuple, device) -> torch.Tensor:
    """uint8 videos [..., F, H, W, 3] with the structure of a scene: a
    random field drawn at 1/8 of the frame rate and about 1/8 of the
    height and width, upsampled (trilinear), plus pixel noise (std 20),
    so that videos differ in where things are and the maps they give
    differ too; drawn on `device` in two calls."""
    g = generator(seed, tag, device)
    *lead, f, h, w, c = shape
    n = math.prod(lead)
    low = torch.rand((n, c, -(-f // 8), -(-h // 8), -(-w // 8)),
                     generator=g, device=device) * 255.0
    out = torch.empty((n, f, h, w, c), dtype=torch.uint8, device=device)
    for i in range(n):  # one video at a time bounds the float32 staging
        up = torch.nn.functional.interpolate(
            low[i:i + 1], size=(f, h, w), mode="trilinear",
            align_corners=False)[0]
        up += 20.0 * torch.randn(up.shape, generator=g, device=device)
        out[i] = up.clamp_(0, 255).round_().permute(1, 2, 3, 0)
    return out.reshape(shape)
