"""B4's phases G and W on the CPU: their plans (pure functions of the
shapes, mirrored by the C sources and compared there by a card test) and
numpy-level emulations of how the bf16 kernels walk their operands, held
against the plain convs they replace.

Phase G (`csrc/convgru_bwd_gates.cu`): the weights packed [N][9U] by
`gates_weight`, walked in 64-deep K chunks of 16-deep steps, each step's A
operand the padded frame shifted by the step's tap. Phase W
(`csrc/convgru_wgrad.cu`): the K grid of RS positions per row with zero
rows between frames, three input copies shifted by dx, tap (dy, dx) read
from copy dx at row dy * RS. Both emulations must equal `conv3x3` and
`kernel_grad` at f32 resolution (rtol 1e-5, atol 1e-5: only the summation
order differs).
"""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels.convgru import (
    SMEM_LIMIT, conv3x3, kernel_grad)

TOL = dict(rtol=1e-5, atol=1e-5)
HWS = [(7, 7), (5, 9)]


def _bf16_values(rng, *shape):
    """Values exactly representable in bf16, so rounding plays no part."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("units,tiles,nbuf", [
    (16, (32, 16), 1), (48, (32, 16), 2), (64, (128, 64), 1),
    (96, (64, 32), 2), (112, (32, 16), 2), (128, (128, 128), 1)])
def test_gates_plan(units, tiles, nbuf):
    """Phase G's N tiles are wgmma widths dividing 2U and U; r*h
    overwrites h in place exactly when the r columns lie in the first
    conv's last N tile; the ring is 2..4 stages and the CTA fits shared
    memory at both grids."""
    for hw in HWS:
        plan = v1.gates_plan(*hw, units)
        assert (plan["bn1"], plan["bn2"]) == tiles
        assert plan["nbuf"] == nbuf
        assert 2 <= plan["stages"] <= v1.GATES_MAX_STAGES
        assert v1.gates_smem_bytes(*hw, units, 2) <= SMEM_LIMIT
    assert v1.gates_plan(7, 7, 128)["stages"] == 3


def _gates_conv_emulated(x: torch.Tensor, kernel: torch.Tensor
                         ) -> torch.Tensor:
    """One frame's conv as the bf16 kernel walks it: x [H,W,K], kernel
    [3,3,K,N] -> [H,W,N]."""
    h, w, k_in = x.shape
    wp = w + 2
    m_tiles = -(-h * wp // 64)
    pad = torch.zeros(64 * m_tiles + 2 * wp + 2, k_in)
    for y in range(h):
        pad[(y + 1) * wp + 1:(y + 1) * wp + 1 + w] = x[y]
    packed = v1.gates_weight(kernel, torch.bfloat16).float()  # [N][9K]
    assert packed.shape == (kernel.shape[3], 9 * k_in)
    out = torch.zeros(64 * m_tiles, kernel.shape[3])
    rows = torch.arange(64 * m_tiles)
    for kc in range(-(-9 * k_in // v1.GATES_CHUNK)):
        for j in range(v1.GATES_CHUNK // 16):
            k = kc * v1.GATES_CHUNK + 16 * j
            if k >= 9 * k_in:
                continue
            tap, c = divmod(k, k_in)
            a = pad[rows + (tap // 3) * wp + tap % 3, c:c + 16]
            out += a @ packed[:, k:k + 16].T
    return torch.stack([out[y * wp:y * wp + w] for y in range(h)])


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("units", [16, 48])
def test_gates_k_walk_matches_conv3x3(hw, units):
    rng = np.random.RandomState(units)
    for n in (2 * units, units):
        x = _bf16_values(rng, *hw, units)
        kernel = _bf16_values(rng, 3, 3, units, n)
        got = _gates_conv_emulated(x, kernel)
        want = conv3x3(x[None], kernel)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _wgrad_emulated(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum over frames of patches(x)^T g as the bf16 kernel walks it:
    x [F,H,W,C], g [F,H,W,N] -> [3,3,C,N]."""
    frames, h, w, c = x.shape
    rs, p, xr = v1.wgrad_grid(h, w)
    assert rs % 8 == 0 and p % 16 == 0 and p >= (h + 1) * rs
    out = torch.zeros(3, 3, c, g.shape[-1])
    for f in range(frames):
        copies = torch.zeros(3, xr, c)
        tile = torch.zeros(p, g.shape[-1])
        for y in range(h):
            for xx in range(w):
                tile[y * rs + xx] = g[f, y, xx]
                for dx in range(3):
                    xs = xx + 1 - dx
                    if xs >= 0:
                        assert xs < rs
                        copies[dx, (y + 1) * rs + xs] = x[f, y, xx]
        for dy in range(3):
            for dx in range(3):
                out[dy, dx] += copies[dx, dy * rs:dy * rs + p].T @ tile
    return out


@pytest.mark.parametrize("hw", HWS)
def test_wgrad_k_grid_matches_kernel_grad(hw):
    rng = np.random.RandomState(hw[1])
    x = _bf16_values(rng, 3, *hw, 5)
    g = _bf16_values(rng, 3, *hw, 6)
    np.testing.assert_allclose(_wgrad_emulated(x, g).numpy(),
                               kernel_grad(x, g).numpy(), **TOL)


@pytest.mark.parametrize("hw", HWS)
def test_g_and_w_fit_every_width_b2_takes(hw):
    """Phases G and W take every U that B2 takes at the model's grids (in
    bf16 up to 128), so routing V2 through them shrinks V2's domain
    nowhere."""
    widths = [u for u in range(16, 257, 16)
              if v2.kernel_takes(*hw, u, torch.bfloat16)]
    assert widths == list(range(16, 129, 16))
    for units in widths:
        assert v1.gates_smem_bytes(*hw, units, 2) <= SMEM_LIMIT, units
        assert v1.wgrad_takes(*hw, units, 2), units
        assert v1.wgrad_smem_bytes(*hw, units, 2) <= SMEM_LIMIT
    assert not v1.wgrad_takes(*hw, 24, 2)
    assert not v1.wgrad_takes(17, 17, 16, 2)  # a frame past one TMA box
