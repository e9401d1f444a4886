"""Tests that need a CUDA card: the hand-written ConvGRU kernel against its
plain PyTorch version at shapes chip_smoke.py does not cover. They skip
without a card. This file imports torch only (no jax), so on a machine
with a card it runs without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_no_tf32():
    """The card, with TF32 off so the f32 plain version is true f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _inputs(t, b, hw, units, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    h, w = hw
    fused = {
        "Uh_zr": rng.randn(3, 3, units, 2 * units) * 0.1,
        "U_c": rng.randn(3, 3, units, units) * 0.1,
    }
    fused = {k: torch.from_numpy(v.astype(np.float32)).to(device)
             for k, v in fused.items()}
    wx = torch.from_numpy(rng.randn(t, b, h, w, 3 * units).astype(
        np.float32)).to(device=device, dtype=dtype)
    h0 = torch.from_numpy(rng.randn(b, h, w, units).astype(
        np.float32) * 0.5).to(device)
    return fused, wx, h0


@pytest.mark.parametrize("t,b,hw,units", [
    (1, 1, (7, 7), 16),
    (5, 3, (7, 7), 32),
    (4, 2, (5, 9), 48),
    (3, 32, (7, 7), 128),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_kernel_matches_plain(cuda_no_tf32, t, b, hw, units, dtype):
    fused, wx, h0 = _inputs(t, b, hw, units, dtype, cuda_no_tf32)
    cdt = None if dtype == torch.float32 else dtype
    before = kconv.launches
    with torch.inference_mode():
        h_k, ys_k = kconv.convgru_recurrence(fused, wx, h0)
        h_p, ys_p = ConvGRU.scan_precomputed(fused, wx, h0, cdt)
    torch.cuda.synchronize()
    assert kconv.launches == before + 1
    assert ys_k.dtype == torch.float32 and ys_k.shape == ys_p.shape
    assert torch.equal(h_k, ys_k[-1])
    a, k = ys_p.cpu().numpy(), ys_k.cpu().numpy()
    if dtype == torch.float32:
        # summation order only: the JAX package's kernel tolerance
        np.testing.assert_allclose(k, a, rtol=1e-4, atol=1e-5)
    else:
        # the plain path rounds each conv result to bf16, the kernel keeps
        # f32: bounded by bf16 resolution (the parity gate's 0.05 relative)
        assert np.abs(k - a).max() <= 0.05 * np.abs(a).max()
        assert np.corrcoef(k.ravel(), a.ravel())[0, 1] >= 0.999


def test_convgru_kernel_rejects_shapes_it_does_not_take(cuda_no_tf32):
    fused, wx, h0 = _inputs(2, 1, (7, 7), 8, torch.bfloat16, cuda_no_tf32)
    with pytest.raises(ValueError, match="multiple of 16"):
        kconv.convgru_recurrence(fused, wx, h0)
