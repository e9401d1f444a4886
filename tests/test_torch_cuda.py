"""Tests that need a CUDA card: the hand-written recurrence kernels (ConvGRU
forward B1, backward B2 and B4 with its phases G and W; ConvLSTM forward
B3) against their plain PyTorch versions at shapes chip_smoke.py does not
cover, B4 bitwise repeatable and free of library products, and the cluster
kernels' (B1, B2, B3) shared-memory reckoning and refusal of widths that do
not fit; the models' routing of other widths to the plain scan (fault C1);
the raw-video front (the C3D tower's bf16 gate, fused predict and two
`cli.train_fused` steps, with launch counts); each family of the model
zoo's predict in bf16 against f32; evaluation (the metrics
on the card against the CPU, one B1 launch per evaluated batch) and the
prefetched trainer against the inline one; and observability (the FLOP
count of the kernel route against the plain route's, a profiled train
step naming B1 and B2); and the int8 C3D tower (kernel Q1 and Q1-pool
bitwise against their plain versions, the int8 tower and fused_int8
predict with their launch counts); and the served video's upload (the
staged maps bitwise the direct upload's, two callers, a lane's copy beside
a kernel of the compute stream); and kernel B5, the cascade's small ConvGRU
(forward and backward against their plain versions, its weight gradients
bitwise repeatable, its reckoning, its refusals, and the cascade's train
step launching it once each way); and kernel B6, the cascade's wide
ConvGRU (the same, with the plain versions' sums rounded to bf16 as the
control its gates refuse, a batch larger than one launch holds, and the
cascade's gradients through it against the plain scan's); and kernel M1,
the dense layers' bf16 products (each product at the cascade's shapes
within 2x of an f32 GEMM's error, the single-term control refused, odd
shapes against its plain versions, the route's rounding and repeatability),
with the cascade's input conv and upsample on their card routes. They skip
without a card. This
file imports torch only (no jax), so on a machine with a card it runs
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU, ConvLSTM
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2

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


# B5 against its plain versions on the card (chip_smoke.py's gates): ys
# to the plain version's bits (the largest difference over the largest
# magnitude; B5 makes each conv's f32 sum in the plain conv's order), each
# gradient by its norm, ||kernel - plain|| / ||plain||, with dwx in bf16 as
# the wrapper returns it. Each limit lies between the largest sound reading
# and the smallest of the control (the plain versions with their sums
# rounded to bf16), seeds 0-2 at B=28, T=42 on an H100: dwx 1.66e-3 /
# 2.95e-3, dh0 1.63e-3 / 2.66e-3, dU_zr 1.98e-3 / 3.48e-3, dU_c 1.69e-3 /
# 3.22e-3.
SMALL_FWD_TOL = 1e-6
SMALL_BWD_TOL = {"dwx": 2.2e-3, "dh0": 2.1e-3, "dU_zr": 2.6e-3,
                 "dU_c": 2.4e-3}

# U=128 runs on clusters of 8 CTAs: B=1 and 8 in one wave, 28 (the train
# batch) and 32 in two
CLUSTER_SHAPES = [(4, 1, (7, 7), 128), (4, 8, (7, 7), 128),
                  (4, 28, (7, 7), 128)]
# U=64 (gaze_pupil_grcn) runs on clusters of 4 CTAs of 16 channels each
C4_SHAPES = [(4, 1, (7, 7), 64), (4, 7, (7, 7), 64), (4, 28, (7, 7), 64)]


@pytest.mark.parametrize("t,b,hw,units", [
    (1, 1, (7, 7), 16),
    (5, 3, (7, 7), 32),
    (4, 2, (5, 9), 48),
    (3, 32, (7, 7), 128),
] + CLUSTER_SHAPES + C4_SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cluster_kernels_reject_a_width_whose_slice_does_not_fit(
        cuda_no_tf32, dtype):
    """U=256 on clusters of 8: a CTA's slices need more shared memory than
    the card has; both wrappers raise before launching."""
    fused, wx, h0 = _inputs(1, 1, (7, 7), 256, dtype, cuda_no_tf32)
    before = (kconv.launches, v2.launches)
    with pytest.raises(ValueError, match="shared memory"):
        kconv.convgru_recurrence(fused, wx, h0)
    streams = _gates(1, 1, (7, 7), 256, cuda_no_tf32, seed=1)
    cdt = None if dtype == torch.float32 else dtype
    with pytest.raises(ValueError, match="shared memory"):
        v2.dh_bwd(*streams, fused["Uh_zr"], fused["U_c"], cdt)
    assert (kconv.launches, v2.launches) == before


@pytest.mark.parametrize("units", [16, 32, 48, 128])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_cluster_shared_memory_reckoning_matches_the_sources(
        cuda_no_tf32, units, hw):
    """The wrappers' reckoning (which they check before a launch) is the
    kernels' own, and at least one cluster of each fits the card."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import build

    lib = build.load()
    for elem in (2, 4):
        assert kconv.smem_bytes(*hw, units, elem) == \
            lib.convgru_fwd_smem_bytes(*hw, units, elem)
        assert v2.smem_bytes(*hw, units, elem) == \
            lib.convgru_bwd_smem_bytes(*hw, units, elem)
        assert klstm.smem_bytes(*hw, units, elem) == \
            lib.convlstm_fwd_smem_bytes(*hw, units, elem)
        assert lib.convgru_fwd_max_clusters(*hw, units, elem) >= 1
        assert lib.convgru_bwd_max_clusters(*hw, units, elem) >= 1
        assert lib.convlstm_fwd_max_clusters(*hw, units, elem) >= 1


SHAPES = [(1, 1, (7, 7), 16), (4, 3, (7, 7), 32), (3, 2, (5, 9), 48),
          (3, 8, (7, 7), 128)]


def _assert_close(kernel, plain, dtype):
    k, a = kernel.float().cpu().numpy(), plain.float().cpu().numpy()
    if dtype == torch.float32:
        # summation order only; its error scales with the size of the
        # summed terms (the weight gradients sum ~T*B*49*9 of them), so
        # the absolute part is relative to the output's scale
        np.testing.assert_allclose(k, a, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(a).max()))
    else:
        # both round every conv operand to bf16 and sum in f32; they differ
        # by summation order and by single-ulp flips where an elementwise
        # f32 value rounds differently: the parity gate's bound
        assert np.abs(k - a).max() <= 0.05 * np.abs(a).max()
        assert np.corrcoef(k.ravel(), a.ravel())[0, 1] >= 0.999


def _gates(t, b, hw, units, device, seed):
    rng = np.random.RandomState(seed)
    shape = (t, b, *hw, units)
    u, r = (1 / (1 + np.exp(-rng.randn(*shape))) for _ in range(2))
    c = np.tanh(rng.randn(*shape))
    hprev, g = rng.randn(*shape) * 0.5, rng.randn(*shape)
    return [torch.from_numpy(x.astype(np.float32)).to(device)
            for x in (u, r, c, hprev, g)]


# B2 at U=128 also at B=1 and 28 (SHAPES holds B=8)
@pytest.mark.parametrize("t,b,hw,units",
                         SHAPES + [CLUSTER_SHAPES[0], CLUSTER_SHAPES[2]]
                         + C4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_bwd_kernel_matches_plain(cuda_no_tf32, t, b, hw, units,
                                          dtype):
    fused, _, _ = _inputs(t, b, hw, units, dtype, cuda_no_tf32)
    streams = _gates(t, b, hw, units, cuda_no_tf32, seed=1)
    cdt = None if dtype == torch.float32 else dtype
    before = v2.launches
    got = v2.dh_bwd(*streams, fused["Uh_zr"], fused["U_c"], cdt)
    want = v2.dh_bwd_plain(*streams, fused["Uh_zr"], fused["U_c"], cdt)
    torch.cuda.synchronize()
    assert v2.launches == before + 1
    for k, a in zip(got, want):
        assert k.shape == a.shape and k.dtype == torch.float32
        _assert_close(k, a, dtype)


# B4 and its phases: SHAPES and the U=64 shapes, and B=16 at U=128
B4_SHAPES = SHAPES + C4_SHAPES + [(3, 16, (7, 7), 128)]
# phases G and W also at the reference's training batch (B=28, U=128) and
# at gaze_pupil_grcn's shape (U=64, T=35, B=7)
GW_SHAPES = B4_SHAPES + [(4, 28, (7, 7), 128), (35, 7, (7, 7), 64)]


def _b4_inputs(t, b, hw, units, dtype, device):
    fused, wx, h0 = _inputs(t, b, hw, units, dtype, device)
    with torch.no_grad():
        _, ys = kconv.convgru_recurrence(fused, wx, h0)
    g = _gates(t, b, hw, units, device, seed=2)[-1]
    return fused["Uh_zr"], fused["U_c"], wx, ys, h0, g


def _b4_counts():
    return (v1.launches, v1.gates_launches, v2.launches, v1.wgrad_launches)


@pytest.mark.parametrize("t,b,hw,units", B4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_bwd_mono_kernel_matches_plain(cuda_no_tf32, t, b, hw, units,
                                               dtype):
    """B4 (G, B2, W) against the step-by-step plain version; one launch of
    each."""
    args = _b4_inputs(t, b, hw, units, dtype, cuda_no_tf32)
    before = _b4_counts()
    got = v1.convgru_bwd(*args)
    want = v1.convgru_bwd_plain(*args)
    torch.cuda.synchronize()
    assert _b4_counts() == tuple(n + 1 for n in before)
    for k, a in zip(got, want):
        assert k.shape == a.shape and k.dtype == torch.float32
        _assert_close(k, a, dtype)


@pytest.mark.parametrize("t,b,hw,units", GW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_bwd_gates_kernel_matches_recompute_gates(
        cuda_no_tf32, t, b, hw, units, dtype):
    uzr, uc, wx, ys, h0, _ = _b4_inputs(t, b, hw, units, dtype, cuda_no_tf32)
    before = v1.gates_launches
    got = v1.bwd_gates(uzr, uc, wx, h0, ys)
    want = v1.recompute_gates(uzr, uc, wx, h0, ys)
    torch.cuda.synchronize()
    assert v1.gates_launches == before + 1
    assert torch.equal(got[3], want[3])  # h_{t-1} is a copy
    for k, a in zip(got, want):
        assert k.shape == a.shape and k.dtype == torch.float32
        assert k.is_contiguous() and k.data_ptr() % 16 == 0
        _assert_close(k, a, dtype)


@pytest.mark.parametrize("t,b,hw,units", GW_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_wgrad_kernel_matches_plain(cuda_no_tf32, t, b, hw, units,
                                            dtype):
    hprev, rh, da, dz, dr = _gates(t, b, hw, units, cuda_no_tf32, seed=3)
    dzr = torch.cat([dz, dr], dim=-1)
    cdt = None if dtype == torch.float32 else dtype
    before = v1.wgrad_launches
    got = v1.wgrad(hprev, dzr, rh, da, cdt)
    want = v1.wgrad_plain(hprev, dzr, rh, da, cdt)
    torch.cuda.synchronize()
    assert v1.wgrad_launches == before + 1
    for k, a in zip(got, want):
        assert k.shape == a.shape and k.dtype == torch.float32
        _assert_close(k, a, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convgru_bwd_mono_is_bitwise_repeatable(cuda_no_tf32, dtype):
    """Phase W sums its split-K slices in a fixed order: two calls give
    the same bits."""
    args = _b4_inputs(42, 8, (7, 7), 128, dtype, cuda_no_tf32)
    first = v1.convgru_bwd(*args)
    second = v1.convgru_bwd(*args)
    torch.cuda.synchronize()
    for a, k in zip(first, second):
        assert torch.equal(a, k)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_convgru_bwd_mono_runs_no_library_product(cuda_no_tf32, monkeypatch,
                                                  version):
    """With every library product that could stand in for B4's convs and
    contractions made to raise, B4's wrapper (v1) and the trainable
    Function's backward (v2: G, B2 and W inside `ConvGRUFused`) still run
    on the card: their products are all in the hand-written kernels."""
    from recurrent_gaze_prediction_tpu_torch.ops import layers

    args = _b4_inputs(4, 8, (7, 7), 128, torch.bfloat16, cuda_no_tf32)
    want = v1.convgru_bwd_plain(*args)
    uzr, uc, wx, ys, h0, g = args

    def v2_backward():
        leaves = [x.detach().requires_grad_() for x in (uzr, uc, wx, h0)]
        with torch.enable_grad():
            out = v1.ConvGRUFused.apply(*leaves)
        duzr, duc, dwx, dh0 = torch.autograd.grad(out, leaves, g)
        return dwx.float(), dh0, duzr, duc

    def refuse(*_, **__):
        raise AssertionError("a library product ran on B4's path")

    for target, name in ((torch, "matmul"), (torch, "mm"), (torch, "bmm"),
                         (torch, "einsum"), (torch.Tensor, "__matmul__"),
                         (torch.nn.functional, "conv2d"), (layers, "conv2d"),
                         (kconv, "conv2d"), (kconv, "kernel_grad"),
                         (kconv, "conv3x3"), (kconv, "conv3x3_transpose"),
                         (v1, "kernel_grad"), (v1, "conv3x3"),
                         (v1, "conv3x3_transpose"),
                         (v2, "conv3x3_transpose")):
        monkeypatch.setattr(target, name, refuse)
    before = _b4_counts()
    got = v1.convgru_bwd(*args) if version == "v1" else v2_backward()
    torch.cuda.synchronize()
    monkeypatch.undo()
    # G, B2 and W once each (and B4 as a whole for v1)
    assert _b4_counts() == tuple(
        n + (version == "v1" or i > 0) for i, n in enumerate(before))
    for k, a in zip(got, want):
        _assert_close(k, a, torch.bfloat16)


@pytest.mark.parametrize("units", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_b4_phase_reckoning_matches_the_sources(cuda_no_tf32, units, hw):
    """Phase G's shared memory and phase W's plan (tiles, slices, shared
    memory), reckoned in Python, against the C sources' own."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import build

    lib = build.load()
    for elem in (2, 4):
        assert v1.gates_smem_bytes(*hw, units, elem) == \
            lib.convgru_bwd_gates_smem_bytes(*hw, units, elem)
        assert v1.wgrad_tiles(*hw, units, elem) == \
            lib.convgru_wgrad_tiles(*hw, units, elem)
        assert v1.wgrad_smem_bytes(*hw, units, elem) == \
            lib.convgru_wgrad_smem_bytes(*hw, units, elem)
        for frames in (1, 7, 336, 1176):
            assert v1.wgrad_slices(frames, *hw, units, elem) == \
                lib.convgru_wgrad_slices(frames, *hw, units, elem)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_trainable_scan_grads_match_plain_autograd(cuda_no_tf32, version):
    """Both JAX entry points' namesakes (the one Function) on the card
    against autograd of the plain `ConvGRU.scan`, in f32."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.convgru_vjp import (
        convgru_scan_trainable, convgru_scan_trainable_v2)

    scan = {"v1": convgru_scan_trainable, "v2": convgru_scan_trainable_v2}[
        version]
    rng = np.random.RandomState(3)
    t, b, c, units = 5, 2, 24, 32
    params = {k: torch.from_numpy((rng.randn(*v.shape) * 0.1).astype(
        np.float32)).to(cuda_no_tf32).requires_grad_()
        for k, v in ConvGRU.init(c, units).items()}
    xs = torch.from_numpy(rng.randn(t, b, 7, 7, c).astype(np.float32)).to(
        cuda_no_tf32)
    h0 = ConvGRU.zero_state(b, (7, 7), units, device=cuda_no_tf32)
    target = torch.from_numpy(rng.randn(t, b, 7, 7, units).astype(
        np.float32)).to(cuda_no_tf32)
    grads = []
    for fn in (ConvGRU.scan, scan):
        _, ys = fn(params, xs, h0, compute_dtype=torch.float32)
        loss = ((ys - target) ** 2).sum()
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for name, a, k in zip(params, *grads):
        np.testing.assert_allclose(k.cpu().numpy(), a.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def _lstm_inputs(t, b, hw, units, dtype, device, seed=0):
    """B3's inputs with nonzero carries, as the streaming step feeds it."""
    rng = np.random.RandomState(seed)
    h, w = hw
    fused = {"Wh": rng.randn(3, 3, units, 4 * units) * 0.1,
             **{k: rng.randn(h, w, units) * 0.5
                for k in ("W_ci", "W_cf", "W_co")}}
    fused = {k: torch.from_numpy(v.astype(np.float32)).to(device)
             for k, v in fused.items()}
    gx = torch.from_numpy(rng.randn(t, b, h, w, 4 * units).astype(
        np.float32)).to(device=device, dtype=dtype)
    carry = tuple(torch.from_numpy((rng.randn(b, h, w, units) * 0.5).astype(
        np.float32)).to(device) for _ in range(2))
    return fused, gx, carry


# B3 at U=128 on clusters of 8 CTAs: B=1 and 8 in one wave, 16 in two
LSTM_CLUSTER_SHAPES = [(4, 1, (7, 7), 128), (4, 16, (7, 7), 128)]


@pytest.mark.parametrize("t,b,hw,units", SHAPES + LSTM_CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convlstm_kernel_matches_plain(cuda_no_tf32, t, b, hw, units, dtype):
    fused, gx, carry = _lstm_inputs(t, b, hw, units, dtype, cuda_no_tf32)
    cdt = None if dtype == torch.float32 else dtype
    before = klstm.launches
    with torch.inference_mode():
        (c_k, h_k), ys_k = klstm.convlstm_recurrence(fused, gx, *carry)
        (c_p, _), ys_p = ConvLSTM.scan_precomputed(fused, gx, carry, cdt)
    torch.cuda.synchronize()
    assert klstm.launches == before + 1
    assert torch.equal(h_k, ys_k[-1])
    for k, a in ((ys_k, ys_p), (c_k, c_p)):
        assert k.shape == a.shape and k.dtype == torch.float32
        _assert_close(k, a, dtype)


def test_convlstm_kernel_rejects_shapes_it_does_not_take(cuda_no_tf32):
    fused, gx, carry = _lstm_inputs(2, 1, (7, 7), 8, torch.bfloat16,
                                    cuda_no_tf32)
    with pytest.raises(ValueError, match="multiple of 16"):
        klstm.convlstm_recurrence(fused, gx, *carry)
    fused, gx, carry = _lstm_inputs(2, 1, (7, 7), 16, torch.bfloat16,
                                    cuda_no_tf32)
    with pytest.raises(ValueError, match="c0 and h0"):
        klstm.convlstm_recurrence(fused, gx, carry[0][:, :6], carry[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convlstm_kernel_rejects_a_width_whose_slice_does_not_fit(
        cuda_no_tf32, dtype):
    """U=256 on clusters of 8: a CTA needs more shared memory than the card
    has (in bf16 for the resident weight slice, in f32 for the two padded
    operands); the wrapper raises before launching."""
    fused, gx, carry = _lstm_inputs(1, 1, (7, 7), 256, dtype, cuda_no_tf32)
    before = klstm.launches
    with pytest.raises(ValueError, match="shared memory"):
        klstm.convlstm_recurrence(fused, gx, *carry)
    assert klstm.launches == before


# ---------------------------------------------------------------- fault C1

@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
@pytest.mark.parametrize("units", [256, 24, 128])
def test_predict_routes_widths_the_kernels_do_not_take_to_the_scan(
        cuda_no_tf32, name, units):
    """U=24 runs the cell's own scan (no launch), U=128 the cluster kernel
    (one launch); U=256, too wide for the cluster kernels, runs gaze_grcn's
    cell on B6 (one launch) and gaze_lstm's on its scan; each decided
    before any launch."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)

    model = registry.create_model(name, rnn_state_size=units, n_lstm_steps=5,
                                  compute_dtype="bfloat16",
                                  device=cuda_no_tf32)
    c3d = torch.from_numpy(np.random.RandomState(0).randn(
        2, 5, 1024, 7, 7).astype(np.float32)).to(cuda_no_tf32)
    grcn = name == "gaze_grcn"
    kernel = {128: kconv if grcn else klstm, 256: kg if grcn else None}.get(
        units)
    counters = (kconv, klstm, v2, kg)
    before = [m.launches for m in counters]
    maps = model.predict(None, c3d)
    torch.cuda.synchronize()
    launched = [m.launches - b for m, b in zip(counters, before)]
    assert model.last_route == ("scan" if kernel is None else "kernel")
    assert launched == [int(m is kernel) for m in counters]
    assert maps.shape == (2, 5, 49, 49) and bool(torch.isfinite(maps).all())
    sums = maps.reshape(10, -1).sum(-1)
    assert float((sums - 1).abs().max()) <= 1e-3


# ------------------------------------------------------------ the model zoo

ZOO = ["gaze_rnn", "gaze_rnn77", "gaze_c3d_conv",
       "gaze_framewise_shallownet", "gaze_grcn_cascade", "gaze_pupil_grcn",
       "gaze_pupil_gru2"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_family_predicts_on_the_card(cuda_no_tf32, name):
    """Each zoo family below predicts at its registry width in bf16:
    finite, corr >= 0.999 against the same weights in f32 (TF32 off);
    gaze_pupil_grcn launches B1 once (U=64, clusters of 4), the others no
    recurrence kernel."""
    from recurrent_gaze_prediction_tpu_torch import registry

    gen = torch.Generator().manual_seed(0)
    model = registry.create_model(name, n_lstm_steps=5, device=cuda_no_tf32,
                                  compute_dtype="bfloat16", generator=gen)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.startswith("cell.") and p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    rng = np.random.RandomState(1)
    frames = torch.from_numpy(rng.rand(2, 5, 98, 98, 3).astype(
        np.float32)).to(cuda_no_tf32)
    c3d = torch.from_numpy(rng.randn(2, 5, 1024, 7, 7).astype(
        np.float32)).to(cuda_no_tf32)
    before = (kconv.launches, klstm.launches, v2.launches, v1.launches)
    maps = model.predict(frames, c3d)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(
        (kconv.launches, klstm.launches, v2.launches, v1.launches), before)]
    want = [1, 0, 0, 0] if name == "gaze_pupil_grcn" else [0, 0, 0, 0]
    assert launched == want
    model.cfg.compute_dtype = "float32"
    f32 = model.predict(frames, c3d)
    gh = model.cfg.gazemap_height
    assert maps.shape == (2, 5, gh, gh) and bool(torch.isfinite(maps).all())
    a, b = maps.float().flatten().cpu(), f32.flatten().cpu()
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) >= 0.999


# -------------------------------------------------------- the raw-video front

def _tower(device):
    from recurrent_gaze_prediction_tpu_torch.models import c3d

    return c3d.init_params(torch.Generator().manual_seed(1), device=device)


def test_c3d_tower_bf16_matches_f32(cuda_no_tf32):
    """The bf16 tower against the f32 one (TF32 off) at conv5b: corr
    >= 0.999."""
    from recurrent_gaze_prediction_tpu_torch.models import c3d

    tower = _tower(cuda_no_tf32)
    pixels = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (4, 16, 128, 171, 3)).astype(np.uint8)).to(cuda_no_tf32)
    with torch.inference_mode():
        clips = c3d.preprocess_frames(pixels)
        a = c3d.apply(tower, clips, compute_dtype=torch.bfloat16)
        b = c3d.apply(tower, clips, compute_dtype=None)
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == (4, 512, 2, 7, 7) and np.isfinite(a).all()
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
def test_fused_predict_launches_the_recurrence_kernel_once(cuda_no_tf32,
                                                           name):
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.models import pipeline

    model = registry.create_model(name, n_lstm_steps=2,
                                  compute_dtype="bfloat16",
                                  device=cuda_no_tf32)
    video = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 32, 128, 171, 3)).astype(np.uint8)).to(cuda_no_tf32)
    fn = pipeline.make_fused_predict(model, num_frames=32)
    before = (kconv.launches, klstm.launches, v2.launches, v1.launches)
    maps = fn(_tower(cuda_no_tf32), video)
    torch.cuda.synchronize()
    after = (kconv.launches, klstm.launches, v2.launches, v1.launches)
    delta = [a - b for a, b in zip(after, before)]
    assert delta == ([1, 0, 0, 0] if name == "gaze_grcn" else [0, 1, 0, 0])
    assert maps.shape == (2, 2, 49, 49) and bool(torch.isfinite(maps).all())


def test_cli_train_fused_two_steps(cuda_no_tf32, tmp_path):
    """Two frozen-tower steps of `cli.train_fused` on the card: B1 and B2
    once per step, a checkpoint written."""
    from recurrent_gaze_prediction_tpu_torch.cli import train_fused
    from recurrent_gaze_prediction_tpu_torch.train import Checkpointer

    run = str(tmp_path / "run")
    before = (kconv.launches, v2.launches, klstm.launches, v1.launches)
    assert train_fused.main([
        "--dataset", "synthetic", "--num_frames", "32", "--frame_hw", "128",
        "171", "--batch_size", "2", "--synthetic_clips", "2", "--max_steps",
        "2", "--steps_per_logprint", "1", "--train_dir", run]) == 0
    torch.cuda.synchronize()
    after = (kconv.launches, v2.launches, klstm.launches, v1.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 0, 0]
    assert Checkpointer(run).steps() == [2]


def _eval_maps(n, hw=21, seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.rand(n, hw, hw).astype(np.float32) + 0.05
    noisy = (gt + 0.5 * rng.rand(n, hw, hw)).reshape(n, -1)
    # a rank map: values 1/hw^2 apart, so AUC_Judd's jitter decides nothing
    pred = (np.argsort(np.argsort(noisy, -1), -1) / hw ** 2).astype(
        np.float32).reshape(n, hw, hw)
    fix = (rng.rand(n, hw, hw) < 0.02).astype(np.float32)
    fix[0] = 0.0
    return pred, gt, fix


def test_metrics_on_the_card_match_the_cpu(cuda_no_tf32):
    """All seven metrics through `evaluate_batch` (exact, a given other
    map), in chunks of 24 of 64 frames, on the card and on the CPU."""
    from recurrent_gaze_prediction_tpu_torch.eval import metrics_torch as mt

    host = [torch.from_numpy(x) for x in _eval_maps(64)]
    other = (host[2][1:11] > 0).sum(0)

    def run(tensors, other_map):
        dev = tensors[0].device
        return mt.evaluate_batch(
            *tensors, torch.Generator(device=dev).manual_seed(0),
            metrics=mt.ALL_METRICS, other_map=other_map, chunk_size=24)

    on_card = run([x.to(cuda_no_tf32) for x in host],
                  other.to(cuda_no_tf32))
    on_cpu = run(host, other)
    for m in mt.ALL_METRICS:
        a, b = on_card[m].cpu().numpy(), on_cpu[m].numpy()
        assert a.shape == (64,)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=m)


def _small_grcn(device, **overrides):
    """gaze_grcn at a width B1 takes (U=16, one CTA per cluster) on the
    synthetic corpus's 1024-channel features, T=3, B=2."""
    from recurrent_gaze_prediction_tpu_torch import registry

    kw = dict(dim_feature=1024, dim_cnn_proj=8, rnn_state_size=16,
              n_lstm_steps=3, batch_size=2, compute_dtype="bfloat16")
    kw.update(overrides)
    return registry.create_model("gaze_grcn", device=device,
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)


def test_evaluation_launches_the_forward_kernel_once_per_batch(
        cuda_no_tf32):
    """5 clips at B=2: three batches, three B1 launches and no other
    kernel; the maps stay on the card."""
    from recurrent_gaze_prediction_tpu_torch.data import synthetic
    from recurrent_gaze_prediction_tpu_torch.eval import evaluator
    from recurrent_gaze_prediction_tpu_torch.train import make_predict_fn

    model = _small_grcn(cuda_no_tf32)
    valid = synthetic.make_clip_windows(5, 3, seed=1)
    before = (kconv.launches, v2.launches, klstm.launches, v1.launches)
    ret, scores = evaluator.generate_and_evaluate(
        make_predict_fn(model), valid, 2, max_instances=None,
        input_cast=torch.bfloat16, device=cuda_no_tf32)
    torch.cuda.synchronize()
    after = (kconv.launches, v2.launches, klstm.launches, v1.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 0, 0, 0]
    assert ret["pred_gazemaps"].is_cuda
    assert ret["pred_gazemaps"].shape == (15, 49, 49)
    assert all(np.isfinite(v) for v in scores.values())


def test_prefetched_trainer_losses_equal_the_inline_trainer(cuda_no_tf32):
    """3 steps of `train.fit` on the card fed by `prefetch_batches` (bf16
    casts on the host, copies on a side stream) and inline: equal losses
    (rel 1e-6)."""
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
    from recurrent_gaze_prediction_tpu_torch.data import synthetic
    from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
        prefetch_batches, stream_casts)
    from recurrent_gaze_prediction_tpu_torch.train import (
        create_train_state, fit)

    def losses(prefetch):
        model = _small_grcn(cuda_no_tf32)
        exp = ExperimentConfig()
        exp.model = model.cfg
        exp.schedule.max_steps = 3
        exp.schedule.steps_per_logprint = 1
        data = synthetic.make_splits(n_train=4, n_valid=2, n_test=2, t=3)
        it = (prefetch_batches(data.train, 2, device=cuda_no_tf32,
                               cast=stream_casts(torch.bfloat16),
                               max_batches=3) if prefetch else None)
        state, tx = create_train_state(model, exp.optimizer)
        rows = []
        fit(model, state, tx, data, exp, train_iterator=it,
            metric_writer=lambda step, v: rows.append(v["loss/train"]))
        return rows

    inline, fed = losses(False), losses(True)
    assert len(inline) == len(fed) == 3
    np.testing.assert_allclose(fed, inline, rtol=1e-6)


def test_apply_attention_on_the_card_matches_the_cpu(cuda_no_tf32):
    """The attention frames on the card against the CPU: the f32 product
    at rtol 1e-6, the uint8 frames at most one level apart."""
    from recurrent_gaze_prediction_tpu_torch.data import video

    rng = np.random.RandomState(0)
    for hw in ((48, 64), (240, 320)):
        frames = torch.from_numpy(rng.randint(0, 256, (16, *hw, 3)).astype(
            np.uint8))
        maps = torch.from_numpy(rng.rand(16, 49, 49).astype(np.float32))
        cpu = video.apply_attention(frames.float(), maps)
        card = video.apply_attention(frames.float().to(cuda_no_tf32),
                                     maps.to(cuda_no_tf32))
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=1e-4)
        delta = (video.apply_attention(frames.to(cuda_no_tf32),
                                       maps.to(cuda_no_tf32)).cpu().int()
                 - video.apply_attention(frames, maps).int()).abs()
        assert int(delta.max()) <= 1


def _map_run(tmp_path, name):
    """A port run dir of `name` at a width the kernels take (U=16), f32,
    and three clip folders without frame files whose `.c3d` files hold
    11, 3 and 1 windows."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig
    from recurrent_gaze_prediction_tpu_torch.data import codec
    from recurrent_gaze_prediction_tpu_torch.train import (
        Checkpointer, create_train_state)

    model = registry.create_model(
        name, device="cpu", generator=torch.Generator().manual_seed(0),
        dim_cnn_proj=16, rnn_state_size=16, compute_dtype="float32")
    exp = ExperimentConfig()
    exp.model = model.cfg
    with torch.no_grad():
        for p in model.cell.values():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
    state, _ = create_train_state(model, exp.optimizer)
    run = str(tmp_path / "run")
    ckpt = Checkpointer(run)
    ckpt.save(state)
    ckpt.save_config(exp)
    clips = tmp_path / "clips"
    rng = np.random.RandomState(2)
    for clip, n in (("a", 11), ("b", 3), ("c", 1)):
        (clips / clip).mkdir(parents=True)
        codec.write_c3d_file(str(clips / f"{clip}.c3d"), list(
            rng.rand(n, 512, 2, 7, 7).astype(np.float32)))
    return run, str(clips)


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
@pytest.mark.parametrize("streaming", [False, True])
def test_extract_map_on_the_card(cuda_no_tf32, tmp_path, name, streaming):
    """cli.extract_map on the card against --device cpu: the float16 maps
    within 1e-3 (f32 kernels against the plain scans), and the model's
    forward kernel launched once per predicted batch (3 clips at B=2: 2)
    or per streamed chunk (11, 3 and 1 windows in chunks of 4: 3 + 1 +
    1)."""
    from recurrent_gaze_prediction_tpu_torch.cli import extract_map

    run, clips = _map_run(tmp_path, name)
    args = ["--train_dir", run, "--clips_root", clips, "--n_lstm_steps",
            "8", "--batch_size", "2"]
    if streaming:
        args += ["--streaming", "--chunk_len", "4"]
    counter = kconv if name == "gaze_grcn" else klstm
    before = counter.launches
    assert extract_map.main(args + ["--out_dir", str(tmp_path / "card")]) \
        == 0
    torch.cuda.synchronize()
    assert counter.launches - before == (5 if streaming else 2)
    assert extract_map.main(args + ["--out_dir", str(tmp_path / "cpu"),
                                    "--device", "cpu"]) == 0
    for clip in ("a", "b", "c"):
        card = np.load(tmp_path / "card" / f"{clip}.gazemap.npy")
        cpu = np.load(tmp_path / "cpu" / f"{clip}.gazemap.npy")
        assert card.shape == cpu.shape
        np.testing.assert_allclose(card.astype(np.float32),
                                   cpu.astype(np.float32), rtol=1e-3,
                                   atol=1e-3)


def _flops(fn, *args):
    from recurrent_gaze_prediction_tpu_torch.utils import mfu

    return mfu.flop_counts(fn, *args)


def test_kernel_route_counts_the_plain_route_contractions(cuda_no_tf32):
    """FlopCounterMode does not see the ctypes launches, so each wrapper
    adds its own count: at T=42, B=8, 512 -> 128 in bf16 the kernel route
    counts what the plain route counts, B1's and B2's share each
    T*B*49*9*U*3U*2 (14.57 GFLOP), B3's T*B*49*9*U*4U*2; training adds
    only ConvGRUFused's gate recompute (phase G; phase W counts what the
    plain route's weight gradients count)."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.convgru_vjp import (
        convgru_scan_trainable_v2)

    dev, cdt = cuda_no_tf32, torch.bfloat16
    t, b, c, units = 42, 8, 512, 128
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(t, b, 7, 7, c).astype(np.float32)).to(
        dev)

    def weights(init):
        return {k: torch.from_numpy((rng.randn(*v.shape) * 0.05).astype(
            np.float32)).to(dev).requires_grad_() for k, v in init.items()}

    gru = weights(ConvGRU.init(c, units))
    # h0 takes a gradient, so the plain backward forms dh0 as B2 does
    h0 = ConvGRU.zero_state(b, (7, 7), units, device=dev).requires_grad_()
    want = kconv.flops(t, b, 7, 7, units, 3)
    assert want == 14_566_293_504
    kernel = _flops(kconv.convgru_scan, gru, xs, h0, cdt)
    plain = _flops(ConvGRU.scan, gru, xs, h0, cdt)
    assert kernel["convgru_fwd"] == want
    assert sum(kernel.values()) == sum(plain.values())

    def train(scan):
        _, ys = scan(gru, xs, h0, compute_dtype=cdt)
        torch.autograd.grad(ys.float().square().sum(), [*gru.values(), h0])

    kernel = _flops(train, convgru_scan_trainable_v2)
    plain = _flops(train, ConvGRU.scan)
    with torch.no_grad():
        fused = ConvGRU.fuse(gru)
        wx = ConvGRU.input_gates(fused, xs, cdt)
        _, ys = kconv.convgru_recurrence(fused, wx, h0)
    recompute = _flops(v1.recompute_gates, fused["Uh_zr"], fused["U_c"], wx,
                       h0, ys)
    assert kernel["convgru_fwd"] == kernel["convgru_bwd"] == want
    assert kernel["convgru_bwd_gates"] == kernel["convgru_wgrad"] == want
    assert sum(recompute.values()) == want
    assert sum(kernel.values()) == sum(plain.values()) + want

    lstm = weights(ConvLSTM.init(c, units))
    carry = ConvLSTM.zero_state(b, (7, 7), units, device=dev)
    kernel = _flops(klstm.convlstm_scan, lstm, xs, carry, cdt)
    plain = _flops(ConvLSTM.scan, lstm, xs, carry, cdt)
    assert kernel["convlstm_fwd"] == kconv.flops(t, b, 7, 7, units, 4)
    assert sum(kernel.values()) == sum(plain.values())


def test_profiled_train_step_names_b1_and_b2(cuda_no_tf32, tmp_path):
    """`profile_steps` over one full-width train step: the trace holds the
    device kernels of B1 and B2."""
    import glob
    import json

    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.data import synthetic
    from recurrent_gaze_prediction_tpu_torch.data.prefetch import (
        device_put_batch, stream_casts)
    from recurrent_gaze_prediction_tpu_torch.train import (
        create_train_state, make_train_step, profiler)

    model = registry.create_model("gaze_grcn", n_lstm_steps=8, batch_size=4,
                                  compute_dtype="bfloat16", device="cuda")
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    batch = device_put_batch(synthetic.make_clip_windows(4, 8, seed=0)
                             .next_batch(4), cuda_no_tf32,
                             stream_casts(torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch, gen)  # warm-up: the kernels are built and loaded
    profiler.profile_steps(step, (state, batch, gen), 1, str(tmp_path))
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for name in ("convgru_fwd_kernel", "convgru_bwd_kernel"):  # B1, B2
        assert any(name in k for k in kernels), sorted(kernels)


# ------------------------------------------------------------ the int8 tower

def _int8_layer_inputs(n, dhw, cin, cout, device, seed=0):
    """Random int8 activations and a quantized layer in the packed layout."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels.conv3d_int8 import (
        pack_weights)

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, (n, *dhw, cin)).astype(
        np.int8)).to(device)
    wq = torch.from_numpy(pack_weights(rng.randint(
        -127, 128, (cout, cin, 3, 3, 3)).astype(np.int8))).to(device)
    wscale = torch.from_numpy((rng.rand(cout) * 1e-3 + 1e-4).astype(
        np.float32)).to(device)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(
        device)
    return x, wq, wscale, b


@pytest.mark.parametrize("n,dhw,cin,cout", [
    (1, (16, 20, 24), 3, 64),    # conv1a's path: Cin = 3, K packed to 128
    (2, (3, 9, 7), 64, 128),     # a ragged last tile of M
    (1, (8, 14, 14), 128, 256),
    (3, (2, 7, 7), 512, 512),
    # each tower layer at its real D x H x W and channels (conv5b is
    # conv5a's shape with the f32 output)
    (1, (16, 112, 112), 3, 64),   # conv1a: the halo route
    (1, (16, 56, 56), 64, 128),   # conv2a: BK = 64, BN = 128
    (1, (8, 28, 28), 128, 256),   # conv3a
    (1, (8, 28, 28), 256, 256),   # conv3b
    (2, (4, 14, 14), 256, 512),   # conv4a: two Cout tiles of 256
    (2, (4, 14, 14), 512, 512),   # conv4b
    (2, (2, 7, 7), 512, 512),     # conv5a / conv5b
    # boxes ragged in all of d, h and w (tests/test_torch_q1_tiling.py
    # holds the plans to that)
    (2, (6, 10, 18), 128, 256),
    (1, (7, 11, 13), 3, 64),
    (2, (4, 10, 12), 64, 64),     # BN = 64 on Cin = 64
])
@pytest.mark.parametrize("out_f32", [False, True])
def test_conv3d_int8_kernel_matches_plain_bitwise(cuda_no_tf32, n, dhw, cin,
                                                  cout, out_f32):
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8

    x, wq, wscale, b = _int8_layer_inputs(n, dhw, cin, cout, cuda_no_tf32)
    xscale = 0.0123
    # the next layer's scale spans the outputs' range, as calibration does
    nxt = None if out_f32 else float(conv3d_int8.conv3d_int8_plain(
        x, wq, wscale, b, xscale).max()) / 127.0
    before = conv3d_int8.launches
    got = conv3d_int8.conv3d_int8(x, wq, wscale, b, xscale, nxt)
    torch.cuda.synchronize()
    assert conv3d_int8.launches == before + 1
    want = conv3d_int8.conv3d_int8_plain(x, wq, wscale, b, xscale, nxt)
    assert got.dtype == want.dtype and got.shape == (n, *dhw, cout)
    assert torch.equal(got, want)
    # the plain version on the CPU computes the same bits
    cpu = conv3d_int8.conv3d_int8_plain(x.cpu(), wq.cpu(), wscale.cpu(),
                                        b.cpu(), xscale, nxt)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 16, 12, 10, 64), (1, 2, 2), (1, 2, 2)),
    ((1, 4, 14, 14, 256), (2, 2, 2), (2, 2, 2)),
    ((1, 3, 7, 5, 32), (2, 2, 2), (2, 2, 2)),    # SAME pads the high side
])
def test_maxpool3d_int8_kernel_matches_plain(cuda_no_tf32, shape, window,
                                             stride):
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8

    x = torch.from_numpy(np.random.RandomState(4).randint(
        -128, 128, shape).astype(np.int8)).to(cuda_no_tf32)
    before = conv3d_int8.pool_launches
    got = conv3d_int8.maxpool3d_int8(x, window, stride)
    torch.cuda.synchronize()
    assert conv3d_int8.pool_launches == before + 1
    assert torch.equal(got, conv3d_int8.maxpool3d_int8_plain(x, window,
                                                             stride))


def _sane_tower(device, seed=5):
    """C3D conv weights under which activations survive all eight layers
    (w / sqrt(27 Cin), small biases)."""
    from recurrent_gaze_prediction_tpu_torch.models import c3d

    rng = np.random.RandomState(seed)
    params, cin = {}, 3
    for name, cout in c3d.CONV_LAYERS:
        params[f"{name}_w"] = torch.from_numpy((rng.randn(
            cout, cin, 3, 3, 3) / np.sqrt(27.0 * cin)).astype(np.float32))
        params[f"{name}_b"] = torch.from_numpy(
            (0.01 * rng.randn(cout)).astype(np.float32))
        cin = cout
    return {k: v.to(device) for k, v in params.items()}


def test_int8_tower_on_the_card_matches_the_cpu(cuda_no_tf32):
    """The whole int8 tower through Q1 and Q1-pool (8 + 4 launches) equals
    the plain tower on the CPU bit for bit, and tracks the f32 tower."""
    from recurrent_gaze_prediction_tpu_torch.models import c3d, quant
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8

    tower = _sane_tower(cuda_no_tf32)
    pixels = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (2, 16, 128, 171, 3)).astype(np.uint8)).to(cuda_no_tf32)
    clips = c3d.preprocess_frames(pixels)
    qparams = quant.quantize_for_pipeline(tower, calib_clips=clips)
    before = (conv3d_int8.launches, conv3d_int8.pool_launches)
    got = quant.apply_int8(qparams, clips)
    torch.cuda.synchronize()
    assert (conv3d_int8.launches - before[0],
            conv3d_int8.pool_launches - before[1]) == (8, 4)
    cpu_q = {k: v.cpu() for k, v in qparams.items()}
    want = quant.apply_int8(cpu_q, clips.cpu())
    assert got.shape == (2, 512, 2, 7, 7)
    assert torch.equal(got.cpu(), want)
    ref = c3d.apply(tower, clips, compute_dtype=None)
    a, r = got.cpu().numpy().ravel(), ref.cpu().numpy().ravel()
    assert np.corrcoef(a, r)[0, 1] > 0.995
    assert np.abs(a - r).mean() / np.abs(r).mean() < 0.06


def test_fused_int8_predict_launches_q1(cuda_no_tf32, tmp_path):
    """A bundle's fused_int8 program on the card: one Q1 launch per layer
    (8) and one Q1-pool launch per pool (4) per call, maps near fused."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.models import quant
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8
    from recurrent_gaze_prediction_tpu_torch.serving import (
        fused_int8_predict_fn, fused_predict_fn, load_bundle, save_bundle)

    model = registry.create_model("gaze_grcn", n_lstm_steps=2,
                                  compute_dtype="bfloat16",
                                  device=cuda_no_tf32)
    tower = _sane_tower(cuda_no_tf32)
    save_bundle(str(tmp_path), model, c3d_params=tower, num_frames=32,
                int8_qparams=quant.quantize_for_pipeline(tower),
                video_dtype="uint8")
    bundle = load_bundle(str(tmp_path), device=cuda_no_tf32)
    video = np.random.RandomState(7).randint(
        0, 256, (2, 32, 128, 171, 3)).astype(np.uint8)
    before = (conv3d_int8.launches, conv3d_int8.pool_launches)
    got = fused_int8_predict_fn(bundle)(video)
    torch.cuda.synchronize()
    assert (conv3d_int8.launches - before[0],
            conv3d_int8.pool_launches - before[1]) == (8, 4)
    ref = fused_predict_fn(bundle)(video)
    assert got.shape == ref.shape == (2, 2, 49, 49)
    a, r = got.cpu().numpy().ravel(), ref.cpu().numpy().ravel()
    assert np.isfinite(a).all() and np.corrcoef(a, r)[0, 1] >= 0.98


# ------------------------------------------------ the served video's upload

def _served_programs(device, path):
    """Both raw-video programs of one full-width gaze_grcn bundle (F=32)
    on the card: {"fused": fn, "fused_int8": fn}."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.models import quant
    from recurrent_gaze_prediction_tpu_torch.serving import (
        fused_int8_predict_fn, fused_predict_fn, load_bundle, save_bundle)

    model = registry.create_model("gaze_grcn", n_lstm_steps=2,
                                  compute_dtype="bfloat16", device=device)
    tower = _sane_tower(device)
    save_bundle(path, model, c3d_params=tower, num_frames=32,
                int8_qparams=quant.quantize_for_pipeline(tower),
                video_dtype="uint8")
    bundle = load_bundle(path, device=device)
    return {"fused": fused_predict_fn(bundle),
            "fused_int8": fused_int8_predict_fn(bundle)}


def _videos(n, batch=3):
    return [np.random.RandomState(20 + k).randint(
        0, 256, (batch, 32, 128, 171, 3)).astype(np.uint8)
        for k in range(n)]


@pytest.mark.parametrize("program", ["fused", "fused_int8"])
def test_staged_upload_serves_the_direct_uploads_maps(cuda_no_tf32, tmp_path,
                                                      program):
    """A video in host memory goes through an upload lane (its bytes
    counted as `upload.staged_bytes`), the same video already on the card
    directly (0 counted); the maps are bitwise equal."""
    from recurrent_gaze_prediction_tpu_torch.train import profiler

    fn = _served_programs(cuda_no_tf32, str(tmp_path))[program]
    (video,) = _videos(1)
    fn(video)   # warm: kernels, the lane and its buffer
    profiler.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            staged = fn(video).cpu()
            direct = fn(torch.from_numpy(video).to(cuda_no_tf32)).cpu()
        counts = [r["counts"] for r in profiler.records()
                  if r["name"] == "serve.predict"]
    finally:
        profiler.clear()
    assert counts == [{"upload.staged_bytes": video.nbytes},
                      {"upload.staged_bytes": 0}]
    assert staged.shape == (3, 2, 49, 49)
    assert torch.equal(staged, direct)


def test_two_callers_get_each_videos_own_maps(cuda_no_tf32, tmp_path):
    """Two threads send 20 `fused_int8` requests each over 4 seeded videos,
    on the one compute stream they share: every reply is bitwise that
    video's single-threaded reply (a lane reused too early, or a staged
    video freed before its tower read it, would break this)."""
    import threading

    fn = _served_programs(cuda_no_tf32, str(tmp_path))["fused_int8"]
    videos = _videos(4)
    want = [fn(v).cpu() for v in videos]
    wrong, failures = [], []

    def caller(c):
        try:
            for k in range(20):
                i = (k + 2 * c) % len(videos)
                if not torch.equal(fn(videos[i]).cpu(), want[i]):
                    wrong.append((c, k, i))
        except Exception as exc:  # reported by the assert below
            failures.append(repr(exc))

    threads = [threading.Thread(target=caller, args=(c,)) for c in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert failures == [] and wrong == []


def test_lane_copy_overlaps_a_kernel_on_the_compute_stream(cuda_no_tf32,
                                                           tmp_path):
    """With 72 ms of matmuls queued on the caller's stream, a staged
    upload's host-to-device copies run on the lane's stream while they do:
    in the device trace a copy and a kernel on another stream overlap in
    time. The bytes arrive whole."""
    import json

    from recurrent_gaze_prediction_tpu_torch.serving import upload

    dev = cuda_no_tf32
    pool = upload.LanePool(dev)
    video = np.random.RandomState(9).randint(0, 256, (8, 8 << 20),
                                             dtype=np.uint8)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    upload.stage_to_device(video, dev, pool)   # warm: the lane, its buffer
    (a @ a).sum()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(40):
            a @ a
        out, staged = upload.stage_to_device(video, dev, pool)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def stream(e):
        return (e.get("args") or {}).get("stream", e.get("tid"))

    copies = [e for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(copies) == 8 and kernels
    assert len(pool.lanes) == 1 and staged == video.nbytes
    assert any(c["ts"] < k["ts"] + k["dur"] and k["ts"] < c["ts"] + c["dur"]
               and stream(c) != stream(k) for c in copies for k in kernels)
    assert torch.equal(out.cpu(), torch.from_numpy(video))


def test_two_ranks_on_one_card_train_and_predict(cuda_no_tf32, tmp_path):
    """Two gloo ranks on cuda:0 (`torch_parallel_worker.py`): 3 sharded
    train steps of full-width gaze_grcn (bf16, T=42, SGD, flip and dropout
    off) at a global B=8, and sharded predict at B=8, against one process
    on the same inputs: chip_smoke.py's phase-17 gates (the loss equal on
    both ranks and within rel 2e-3, params and their updates at corr >=
    0.999 and max_rel <= 0.05, maps at corr >= 0.999)."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.data import synthetic
    from recurrent_gaze_prediction_tpu_torch.train import (
        create_train_state, make_train_step)
    from torch_parallel_worker import launch, results_of

    widths = dict(dim_cnn_proj=512, rnn_state_size=128, n_lstm_steps=42,
                  compute_dtype="bfloat16", dropout_keep_prob=1.0,
                  use_flip_batch=False)
    gen = torch.Generator().manual_seed(0)
    model = registry.create_model("gaze_grcn", device="cpu", generator=gen,
                                  **widths)
    with torch.no_grad():
        for p in model.cell.values():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    data = synthetic.make_clip_windows(24, 42, seed=3)
    batches = [{k: v for k, v in data.next_batch(8).items()
                if k != "clipnames"} for _ in range(3)]
    c3d = np.random.RandomState(4).randn(8, 42, 1024, 7, 7).astype(
        np.float32)
    spec = dict(name="gaze_grcn", state=state_dict, widths=widths)
    inputs = {"mesh": (2, 1), "devices": ["cuda:0", "cuda:0"],
              "train": dict(spec, opt=dict(method="sgd"), batches=batches),
              "predict": dict(spec, frames=None, c3d=c3d)}
    results = launch(str(tmp_path), 2, inputs, ["train", "predict"])

    model = model.to("cuda")
    p0 = {n: p.detach().float().cpu().numpy().copy()
          for n, p in model.named_parameters()}
    state, tx = create_train_state(model, OptimizerConfig(method="sgd"))
    step = make_train_step(model, tx, use_flip=False)
    losses = [float(step(state, {k: torch.from_numpy(v).cuda()
                                 for k, v in b.items()})[1]["loss"])
              for b in batches]
    ranks = results_of(results, "train")
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=2e-3)
    from recurrent_gaze_prediction_tpu_torch.bridge import jax_name
    for name, p in state.params.items():
        want = p.detach().float().cpu().numpy()
        got = ranks[0]["params"][-1][jax_name(name)]
        for a, b in ((got, want), (got - p0[name], want - p0[name])):
            if b.size > 1:
                assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999
            assert np.abs(a - b).max() <= 0.05 * np.abs(b).max()
    want = model.predict(None, torch.from_numpy(c3d).cuda()).float().cpu()
    for rank in results_of(results, "predict"):
        assert np.corrcoef(rank["maps"].ravel(),
                           want.numpy().ravel())[0, 1] >= 0.999


# ------------------------------------- B5: the small ConvGRU (cascade top)

# (T, B, (H, W), U, K): the cascade's top cell at its train shape, then
# the only (K, U) the kernel takes at small ragged grids (one smaller than
# the kernel's window) and at the largest grid it takes (2,560 pixels: one
# group of five a thread)
SMALL_SHAPES = [(42, 28, (49, 49), 3, 5), (3, 2, (2, 3), 3, 5),
                (4, 3, (13, 6), 3, 5), (3, 2, (40, 64), 3, 5)]


def _small_inputs(t, b, hw, units, k, device, seed=0, std=0.2):
    """Weights whose state convs reach O(1) (std 0.2 over K*K*U taps), wx
    ~ N(0, 1) in bf16, h0 ~ N(0, 0.25), a cotangent ~ N(0, 1)."""
    rng = np.random.RandomState(seed)

    def f32(*shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).to(device)

    uzr = f32(k, k, units, 2 * units, std=std)
    uc = f32(k, k, units, units, std=std)
    wx = f32(t, b, *hw, 3 * units).to(torch.bfloat16)
    h0 = f32(b, *hw, units, std=0.5)
    g = f32(t, b, *hw, units)
    return uzr, uc, wx, h0, g


def _rel(a, b):
    """The largest difference over b's largest magnitude."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _l2_rel(a, b):
    """||a - b|| / ||b||."""
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _small_readings(ks, uzr, uc, wx, h0, g, ys, grads):
    """ys by its largest difference, each gradient (dwx in wx's dtype) by
    its norm, against B5's plain versions on the same inputs."""
    want_ys = ks.forward_plain(uzr, uc, wx, h0)
    want = ks.backward_plain(uzr, uc, wx, h0, ys, g)
    want = (want[0].to(wx.dtype), *want[1:])
    grads = (grads[0].to(wx.dtype), *grads[1:])
    return {"ys": _rel(ys, want_ys),
            **{n: _l2_rel(a, w) for n, a, w in
               zip(("dwx", "dh0", "dU_zr", "dU_c"), grads, want)}}


@pytest.mark.parametrize("t,b,hw,units,k", SMALL_SHAPES)
def test_convgru_small_matches_plain(cuda_no_tf32, t, b, hw, units, k):
    """B5's forward against `forward_plain` and its backward against
    `backward_plain` (on the kernel's ys), both on the card in bf16: the
    same rounding rule; the forward sums in the plain conv's order, the
    backward in its own, and the bf16 roundings that order flips move the
    gradients by a few bf16 steps."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    uzr, uc, wx, h0, g = _small_inputs(t, b, hw, units, k, cuda_no_tf32)
    before = (ks.launches, ks.bwd_launches)
    with torch.no_grad():
        ys = ks.recurrence(uzr, uc, wx, h0)
        got = ks.recurrence_bwd(uzr, uc, wx, h0, ys, g)
        readings = _small_readings(ks, uzr, uc, wx, h0, g, ys, got)
    torch.cuda.synchronize()
    assert (ks.launches, ks.bwd_launches) == (before[0] + 2, before[1] + 1)
    assert ys.dtype == torch.float32 and got[0].dtype == torch.bfloat16
    assert [tuple(a.shape) for a in got] == [
        tuple(wx.shape), tuple(h0.shape), tuple(uzr.shape), tuple(uc.shape)]
    assert readings["ys"] <= SMALL_FWD_TOL, readings
    for name in ("dwx", "dh0", "dU_zr", "dU_c"):
        assert readings[name] <= SMALL_BWD_TOL[name], (name, readings)


def test_convgru_small_gates_refuse_bf16_sums(cuda_no_tf32, monkeypatch):
    """The control: B5's plain versions with every conv's sum rounded to
    bf16 (a kernel one precision short), read against the sound plain
    versions by the same gates, fail the forward's limit and a gradient's,
    at the cascade's train shape."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    uzr, uc, wx, h0, g = _small_inputs(42, 28, (49, 49), 3, 5, cuda_no_tf32,
                                       seed=2)
    with torch.no_grad():
        ys = ks.forward_plain(uzr, uc, wx, h0)
        conv, wgrad = ks.state_conv, ks.weight_grad
        monkeypatch.setattr(ks, "state_conv", lambda *a: conv(*a).to(
            torch.bfloat16).float())
        monkeypatch.setattr(ks, "weight_grad", lambda *a: wgrad(*a).to(
            torch.bfloat16).float())
        ctl_ys = ks.forward_plain(uzr, uc, wx, h0)
        ctl = ks.backward_plain(uzr, uc, wx, h0, ys, g)
        monkeypatch.undo()
        readings = _small_readings(ks, uzr, uc, wx, h0, g, ctl_ys, ctl)
    assert readings["ys"] > SMALL_FWD_TOL, readings
    assert any(readings[n] > SMALL_BWD_TOL[n]
               for n in ("dwx", "dh0", "dU_zr", "dU_c")), readings


def test_convgru_small_backward_is_bitwise_repeatable(cuda_no_tf32):
    """The weight gradients are summed in a fixed order (each CTA's
    chunks, then the B partials): two backwards give the same bits."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    uzr, uc, wx, h0, g = _small_inputs(42, 28, (49, 49), 3, 5,
                                       cuda_no_tf32, seed=1)
    ys = ks.recurrence(uzr, uc, wx, h0)
    first = ks.recurrence_bwd(uzr, uc, wx, h0, ys, g)
    second = ks.recurrence_bwd(uzr, uc, wx, h0, ys, g)
    torch.cuda.synchronize()
    for a, k in zip(first, second):
        assert torch.equal(a, k)


@pytest.mark.parametrize("hw", [(49, 49), (7, 7), (2, 3), (13, 6),
                                (40, 64)])
@pytest.mark.parametrize("units,k", [(3, 5)])
def test_convgru_small_reckoning_matches_the_source(cuda_no_tf32, hw, units,
                                                    k):
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import build
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    lib = build.load()
    for backward in (False, True):
        assert lib.convgru_small_smem_bytes(*hw, k, units, int(backward)) \
            == ks.smem_bytes(*hw, k, units, backward)


def test_convgru_small_refuses_what_it_does_not_take(cuda_no_tf32):
    """A CUDA tensor the kernel does not take raises (no fallback to the
    plain version): f32 wx; U=16, 1 or 4; a 3x3 or 7x7 kernel; a grid of
    more than 2,560 pixels."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    before = ks.launches
    uzr, uc, wx, h0, _ = _small_inputs(2, 1, (9, 9), 3, 5, cuda_no_tf32)
    with pytest.raises(ValueError, match="convgru_small takes"):
        ks.recurrence(uzr, uc, wx.float(), h0)
    for units, k, hw in ((16, 3, (9, 9)), (3, 7, (9, 9)), (1, 5, (9, 9)),
                         (4, 5, (9, 9)), (3, 3, (9, 9)), (3, 5, (51, 51))):
        uzr, uc, wx, h0, _ = _small_inputs(2, 1, hw, units, k, cuda_no_tf32)
        with pytest.raises(ValueError, match="convgru_small takes"):
            ks.recurrence(uzr, uc, wx, h0)
    assert ks.launches == before


def _cascade_on_card(device, t=5):
    from recurrent_gaze_prediction_tpu_torch import registry

    model = registry.create_model(
        "gaze_grcn_cascade", device=device, compute_dtype="bfloat16",
        loss_type="l2", n_lstm_steps=t, dropout_keep_prob=1.0,
        generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"c3d": torch.from_numpy(rng.rand(2, t, 1024, 7, 7).astype(
        np.float32) * 4).to(device),
        "gazemaps": torch.from_numpy(rng.rand(2, t, 49, 49).astype(
            np.float32)).to(device)}
    return model, batch


def test_cascade_train_step_launches_b5_once_each_way(cuda_no_tf32):
    """One cascade train step on the card (bf16, T=5): the top cell takes
    B5, one launch forward and one backward; no plain step runs
    (`recurrence.plain_steps` is not counted: the bottom cell is on B6,
    which counts T `recurrence.kernel_steps` on `gaze.recurrence`). Its
    predict launches B5 once."""
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)
    from recurrent_gaze_prediction_tpu_torch.train import profiler
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state, make_train_step)

    model, batch = _cascade_on_card(cuda_no_tf32)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    step(state, batch, torch.Generator().manual_seed(0))  # warm up
    before = (ks.launches, ks.bwd_launches)
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    counted = {r["name"]: r["counts"] for r in profiler.records()
               if r["counts"]}
    profiler.clear()
    assert (ks.launches, ks.bwd_launches) == (before[0] + 2, before[1] + 1)
    assert counted == {"gaze.recurrence": {"recurrence.kernel_steps": 5}}
    assert model.top_route == "kernel" and model.last_route == "kernel"
    before = ks.launches
    maps = model.predict(None, batch["c3d"])
    torch.cuda.synchronize()
    assert ks.launches == before + 1 and bool(torch.isfinite(maps).all())


def test_cascade_gradients_through_b5_match_the_plain_scan(cuda_no_tf32,
                                                          monkeypatch):
    """The cascade's loss and the top cell's and upsample's gradients on
    the card (bf16, T=5), through B5 and through `ConvGRU.scan` (remat):
    the two rounding rules agree within bf16 resolution. The scan route
    is forced by making B5 refuse the cell (`kernel_takes`)."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_small as ks)

    model, batch = _cascade_on_card(cuda_no_tf32)
    with torch.no_grad():
        for p in model.top_cell.values():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(5)).to(p.device) * 0.05)
    named = [(n, p) for n, p in model.named_parameters()
             if n.startswith("top_cell.") or n == "up_w"]
    out = {}
    for route in ("kernel", "scan"):
        if route == "scan":
            monkeypatch.setattr(ks, "kernel_takes", lambda *_: False)
        loss, _ = model.loss(batch, train=True)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        assert model.top_route == route
        out[route] = (float(loss), grads)
    assert abs(out["kernel"][0] - out["scan"][0]) <= 1e-2 * abs(
        out["scan"][0])
    for (n, _), a, w in zip(named, out["kernel"][1], out["scan"][1]):
        assert _rel(a, w) <= 5e-2, n
        assert float(torch.corrcoef(torch.stack(
            [a.float().flatten(), w.float().flatten()]))[0, 1]) >= 0.999, n


# -------------------------------------- B6: the wide ConvGRU (cascade bottom)

# (T, B, (H, W), U): the cascade's bottom cell at its train shape, a
# smaller grid, and a batch larger than one cooperative launch holds (132
# CTAs at 4 an element: 33), which the wrapper runs in two launches each
# way
GRID_SHAPES = [(42, 28, (7, 7), 256), (3, 2, (5, 6), 256),
               (4, 40, (7, 7), 256)]
GRID_READINGS = ("ys", "h_final", "dwx", "dh0", "dU_zr", "dU_c")
# B6 against its plain versions on the card, each reading by its norm,
# ||kernel - plain|| / ||plain|| (dwx in bf16, as the wrapper returns
# it): the mma sums run in another order than cuDNN's, and where that
# flips a bf16 rounding of a conv operand the flip spreads through the
# remaining steps. Each limit lies between the largest sound reading and
# the smallest of the control (the plain versions with every conv's sum
# rounded to bf16), seeds 0-2 at B=28, T=42 on an H100 (sound / control):
# ys 5.74e-4 / 1.017e-3, h_final 6.17e-4 / 1.032e-3, dwx 1.433e-3 /
# 1.988e-3, dh0 9.88e-4 / 1.673e-3, dU_zr 1.586e-3 / 2.765e-3, dU_c
# 1.298e-3 / 2.459e-3 (the kept gates: 3.71e-4, held to ys's limit).
GRID_TOL = {"ys": 8e-4, "h_final": 8.5e-4, "dwx": 1.7e-3, "dh0": 1.3e-3,
            "dU_zr": 2.1e-3, "dU_c": 1.8e-3}


def _grid_inputs(t, b, hw, units, device, seed=0):
    """Weights whose state convs reach O(1) (std 0.03 over 9U = 2,304
    taps), wx ~ N(0, 1) in bf16, h0 ~ N(0, 0.25), a cotangent ~ N(0, 1)."""
    return _small_inputs(t, b, hw, units, 3, device, seed, std=0.03)


def _grid_want(kg, uzr, uc, wx, h0, g, ys, gates):
    """The plain versions on the kernel's gates and ys: (dwx in wx's dtype,
    dh0, dU_zr, dU_c)."""
    units = uc.shape[-1]
    dwx, dh0 = kg.backward_plain(uzr, uc, h0, ys, gates, g, wx.dtype)
    hprev = kconv.hprev_of(h0, ys)
    duzr, duc = v1.wgrad_plain(hprev, dwx[..., :2 * units],
                               gates[1] * hprev, dwx[..., 2 * units:],
                               wx.dtype)
    return dwx.to(wx.dtype), dh0, duzr, duc


def _grid_readings(ys, grads, want_ys, want):
    return {"ys": _l2_rel(ys, want_ys), "h_final": _l2_rel(ys[-1],
                                                           want_ys[-1]),
            **{n: _l2_rel(a, w) for n, a, w in
               zip(GRID_READINGS[2:], grads, want)}}


@pytest.mark.parametrize("t,b,hw,units", GRID_SHAPES)
def test_convgru_grid_matches_plain(cuda_no_tf32, t, b, hw, units):
    """B6's forward (ys, the final h, the gates it keeps) against
    `forward_plain`, its whole backward (the recursion, then phase W)
    against the plain recursion and phase W's plain version on the
    kernel's ys and gates, both in bf16 on the card; the forward counts T
    `recurrence.kernel_steps`."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)
    from recurrent_gaze_prediction_tpu_torch.train import profiler

    uzr, uc, wx, h0, g = _grid_inputs(t, b, hw, units, cuda_no_tf32)
    chunks = -(-b // kg.max_batch(*hw, units, False, cuda_no_tf32))
    before = (kg.launches, kg.bwd_launches, v1.wgrad_launches)
    profiler.clear()
    with torch.no_grad():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ys, gates = kg.recurrence(uzr, uc, wx, h0, keep_gates=True)
        counts = profiler.counts()
        profiler.clear()
        got = kg.backward(uzr, uc, wx, h0, ys, gates, g)
        want_ys, want_gates = kg.forward_plain(uzr, uc, wx, h0, True)
        readings = _grid_readings(ys, got, want_ys, _grid_want(
            kg, uzr, uc, wx, h0, g, ys, gates))
        gates_rel = _l2_rel(gates, want_gates)
    torch.cuda.synchronize()
    assert counts == {"recurrence.kernel_steps": t}
    assert (kg.launches, kg.bwd_launches, v1.wgrad_launches) == (
        before[0] + 2 * chunks, before[1] + chunks, before[2] + 1)
    assert ys.dtype == torch.float32 and got[0].dtype == torch.bfloat16
    assert [tuple(a.shape) for a in got] == [
        tuple(wx.shape), tuple(h0.shape), tuple(uzr.shape), tuple(uc.shape)]
    assert gates_rel <= GRID_TOL["ys"], gates_rel
    for name in GRID_READINGS:
        assert readings[name] <= GRID_TOL[name], (name, readings)


def test_convgru_grid_gates_refuse_bf16_sums(cuda_no_tf32, monkeypatch):
    """The control: B6's plain versions with every conv's sum rounded to
    bf16 (the state convs, the transposed convs, the weight products: a
    kernel one precision short), read against the sound plain versions by
    the same gates, fail the forward's limits and a gradient's, at the
    cascade's train shape."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)

    uzr, uc, wx, h0, g = _grid_inputs(42, 28, (7, 7), 256, cuda_no_tf32,
                                      seed=2)

    def rounded(fn):
        return lambda *a: fn(*a).to(torch.bfloat16).float()

    with torch.no_grad():
        ys, gates = kg.forward_plain(uzr, uc, wx, h0, True)
        want = _grid_want(kg, uzr, uc, wx, h0, g, ys, gates)
        monkeypatch.setattr(kg, "conv3x3", rounded(kg.conv3x3))
        monkeypatch.setattr(kg, "conv3x3_transpose",
                            rounded(kg.conv3x3_transpose))
        monkeypatch.setattr(v1, "kernel_grad", rounded(v1.kernel_grad))
        ctl_ys, _ = kg.forward_plain(uzr, uc, wx, h0)
        ctl = _grid_want(kg, uzr, uc, wx, h0, g, ys, gates)
        monkeypatch.undo()
        readings = _grid_readings(ctl_ys, ctl, ys, want)
    assert readings["ys"] > GRID_TOL["ys"], readings
    assert readings["h_final"] > GRID_TOL["h_final"], readings
    assert any(readings[n] > GRID_TOL[n] for n in GRID_READINGS[2:]), \
        readings


def test_convgru_grid_backward_is_bitwise_repeatable(cuda_no_tf32):
    """No atomics: the recursion's sums run in a fixed order in each CTA,
    phase W adds its slices in order; two backwards give the same bits,
    and two forwards."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)

    uzr, uc, wx, h0, g = _grid_inputs(42, 28, (7, 7), 256, cuda_no_tf32,
                                      seed=1)
    ys, gates = kg.recurrence(uzr, uc, wx, h0, True)
    again, _ = kg.recurrence(uzr, uc, wx, h0)
    first = kg.backward(uzr, uc, wx, h0, ys, gates, g)
    second = kg.backward(uzr, uc, wx, h0, ys, gates, g)
    torch.cuda.synchronize()
    assert torch.equal(ys, again)
    for a, k in zip(first, second):
        assert torch.equal(a, k)


@pytest.mark.parametrize("hw", [(7, 7), (5, 6), (1, 9), (6, 8)])
def test_convgru_grid_reckoning_matches_the_source(cuda_no_tf32, hw):
    """The wrapper's shared memory against the source's, for one and two
    padded operands; the card holds the whole train batch's CTAs (B=28 at
    U=256: 112) in one cooperative launch each way."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import build
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)

    lib = build.load()
    for pads in (1, 2):
        assert lib.convgru_grid_smem_bytes(*hw, 256, pads) == \
            kg.smem_bytes(*hw, 256, pads)
    for backward in (False, True):
        assert kg.max_batch(7, 7, 256, backward, cuda_no_tf32) >= 28


def test_convgru_grid_refuses_what_it_does_not_take(cuda_no_tf32):
    """A CUDA tensor the kernel does not take raises (no fallback to the
    plain version): f32 wx; U=128 (B1's), 384 (not built); a 5x5 kernel;
    an 8x7 grid (72 output rows)."""
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)

    before = kg.launches
    uzr, uc, wx, h0, _ = _grid_inputs(2, 1, (7, 7), 256, cuda_no_tf32)
    with pytest.raises(ValueError, match="convgru_grid takes"):
        kg.recurrence(uzr, uc, wx.float(), h0)
    for units, k, hw in ((128, 3, (7, 7)), (384, 3, (7, 7)),
                         (256, 5, (7, 7)), (256, 3, (8, 7))):
        uzr, uc, wx, h0, _ = _small_inputs(2, 1, hw, units, k, cuda_no_tf32)
        with pytest.raises(ValueError, match="convgru_grid takes"):
            kg.recurrence(uzr, uc, wx, h0)
    assert kg.launches == before


def test_cascade_train_step_launches_b6_once_each_way(cuda_no_tf32):
    """One cascade train step on the card (bf16, T=5): the bottom cell
    takes B6, one launch forward and one backward (and phase W once), with
    its T steps counted as `recurrence.kernel_steps` on `gaze.recurrence`
    and no plain step; its predict launches B6's forward once and keeps
    no gates."""
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import (
        convgru_grid as kg)
    from recurrent_gaze_prediction_tpu_torch.train import profiler
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state, make_train_step)

    model, batch = _cascade_on_card(cuda_no_tf32)
    state, tx = create_train_state(model, OptimizerConfig())
    step = make_train_step(model, tx)
    step(state, batch, torch.Generator().manual_seed(0))  # warm up
    before = (kg.launches, kg.bwd_launches, v1.wgrad_launches)
    profiler.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    counts = profiler.counts()
    profiler.clear()
    assert (kg.launches, kg.bwd_launches, v1.wgrad_launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    assert counts == {"recurrence.kernel_steps": 5}
    assert model.last_route == "kernel"
    kept = []
    forward = kg._launch_fwd
    kg._launch_fwd = lambda *a, **kw: kept.append(a[4]) or forward(*a, **kw)
    try:
        before = kg.launches
        maps = model.predict(None, batch["c3d"])
        torch.cuda.synchronize()
    finally:
        kg._launch_fwd = forward
    assert kg.launches == before + 1 and kept == [False]
    assert bool(torch.isfinite(maps).all())


def test_cascade_gradients_through_b6_match_the_plain_scan(cuda_no_tf32,
                                                          monkeypatch):
    """The cascade's loss and the bottom cell's and projection's gradients
    on the card (bf16, T=5), through B6 and through `ConvGRU.scan` (remat,
    forced by the model's `recurrence_route`): the two rounding rules
    agree within bf16 resolution."""
    model, batch = _cascade_on_card(cuda_no_tf32)
    with torch.no_grad():
        for p in model.bottom_cell.values():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(6)).to(p.device) * 0.02)
    named = [(n, p) for n, p in model.named_parameters()
             if n.startswith(("bottom_cell.", "c3d_proj."))]
    out = {}
    for route in ("kernel", "scan"):
        if route == "scan":
            monkeypatch.setattr(model, "recurrence_route",
                                lambda train: "scan")
        loss, _ = model.loss(batch, train=True)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        assert model.last_route == route
        out[route] = (float(loss), grads)
    assert abs(out["kernel"][0] - out["scan"][0]) <= 1e-2 * abs(
        out["scan"][0])
    for (n, _), a, w in zip(named, out["kernel"][1], out["scan"][1]):
        assert _rel(a, w) <= 5e-2, n
        assert float(torch.corrcoef(torch.stack(
            [a.float().flatten(), w.float().flatten()]))[0, 1]) >= 0.999, n


# ------------------------- M1: the dense layers' bf16 products, and the convs

# (M, K, N, weight std): the cascade's fc1 and fc2 over T*B = 1,176 frames
# and its projection over T*B*49 positions, with the configuration's init
# stds (rgp_bench/configs/gaze_grcn_cascade.json)
M1_SHAPES = {"fc1": (1176, 7203, 4802, 0.02), "fc2": (1176, 2401, 4802, 0.02),
             "proj": (57624, 1024, 512, 0.005)}
M1_READINGS = ("forward", "input_grad", "weight_grad")


def _m1_operands(name, seed, device):
    """The layer's input as the step feeds it (the projection's relu(N(0,
    1)) * 10 features in bf16; the top cell's states in (-1, 1) for fc1;
    relu'd activations for fc2), its weight, and an f32 cotangent."""
    m, k, n, std = M1_SHAPES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, k, generator=g, device=device)
    a = {"proj": lambda v: (v.relu() * 10).bfloat16(), "fc1": torch.tanh,
         "fc2": torch.relu}[name](a)
    w = torch.randn(k, n, generator=g, device=device) * std
    cot = torch.randn(m, n, generator=g, device=device) * 1e-4
    return a, w, cot


def _m1_readings(a, w, cot, single_term=False):
    """Each product's f32 sums through M1 and through the parent's f32 GEMM
    of f32 copies of the rounded operands, by ||x - f64|| / ||f64|| against
    the f64 product of the same rounded operands and the unrounded
    cotangent: {reading: (M1, parent)}. `single_term` feeds M1 the
    cotangent rounded to one bf16 term (the control)."""
    from recurrent_gaze_prediction_tpu_torch.ops import layers
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import gemm

    (m, k), n = a.shape, w.shape[1]
    a16, w16 = a.bfloat16(), w.bfloat16()
    ap = layers._padded(a, m, layers._up(k))
    wp = layers._padded(w, layers._up(k), layers._up(n))
    terms = layers.split_bf16(cot.bfloat16().float() if single_term
                              else cot, wp.shape[1])
    a64, w64, c64 = a16.double(), w16.double(), cot.double()
    af, wf = a16.float(), w16.float()
    pairs = {
        "forward": (gemm.forward(ap, wp, n), af @ wf, a64 @ w64),
        "input_grad": (gemm.input_grad(terms, wp, k), cot @ wf.t(),
                       c64 @ w64.t()),
        "weight_grad": (gemm.weight_grad(ap, terms, k, n), af.t() @ cot,
                        a64.t() @ c64)}
    return {r: (_l2_rel(new, want), _l2_rel(old, want))
            for r, (new, old, want) in pairs.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(M1_SHAPES))
def test_m1_products_within_twice_the_f32_gemm_error(cuda_no_tf32, name,
                                                     seed):
    """M1's forward, input gradient and weight gradient at the cascade's
    shapes: each within 2x of the f32 GEMM's error against the f64
    product; the control (the cotangent rounded to one bf16 term) is
    refused by the gradients' gate."""
    a, w, cot = _m1_operands(name, seed, cuda_no_tf32)
    got = _m1_readings(a, w, cot)
    ctl = _m1_readings(a, w, cot, single_term=True)
    torch.cuda.synchronize()
    print(f"m1 {name} seed {seed}: " + ", ".join(
        f"{r} {got[r][0]:.3e} / f32 {got[r][1]:.3e} (control "
        f"{ctl[r][0]:.3e})" for r in M1_READINGS))
    for r in M1_READINGS:
        assert got[r][0] <= 2 * got[r][1], (r, got[r])
    for r in M1_READINGS[1:]:
        assert ctl[r][0] > 2 * ctl[r][1], (r, ctl[r])


def test_m1_route_rounds_the_kernel_sums_and_repeats(cuda_no_tf32):
    """`matmul_f32` in bf16 on the card goes through M1 (three launches a
    forward and backward): its output is M1's forward, its gradients M1's
    sums rounded to bf16 in the operands' dtypes, bit for bit, twice; the
    projection's input (no gradient) gets no product."""
    from recurrent_gaze_prediction_tpu_torch.ops import layers
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import gemm

    bf = torch.bfloat16
    for name in ("fc2", "proj"):
        a, w, cot = _m1_operands(name, 4, cuda_no_tf32)
        wanted = name != "proj"
        runs = []
        for _ in range(2):
            aa = a.detach().clone().requires_grad_(wanted)
            ww = w.detach().clone().requires_grad_(True)
            before = gemm.launches
            out = layers.matmul_f32(aa, ww, bf)
            grads = torch.autograd.grad(out, [aa, ww] if wanted else [ww],
                                        cot)
            torch.cuda.synchronize()
            assert gemm.launches == before + 2 + wanted
            runs.append((out, *grads))
        for x, y in zip(*runs):
            assert torch.equal(x, y)
        (m, k), n = a.shape, w.shape[1]
        ap = layers._padded(a, m, layers._up(k))
        wp = layers._padded(w, layers._up(k), layers._up(n))
        terms = layers.split_bf16(cot, wp.shape[1])
        assert torch.equal(runs[0][0], gemm.forward(ap, wp, n))
        assert torch.equal(runs[0][-1],
                           gemm.weight_grad(ap, terms, k, n).to(bf).float())
        if wanted:
            assert torch.equal(runs[0][1],
                               gemm.input_grad(terms, wp, k).to(bf).float())


# (M, K, N): ragged edges in every dimension, a single row, products too
# small to fill the card (split over grid.z) and a wide one
M1_ODD_SHAPES = [(1, 9, 3), (37, 75, 53), (300, 130, 70), (28, 1056, 384),
                 (130, 4000, 200), (2, 8, 1030)]


@pytest.mark.parametrize("m,k,n", M1_ODD_SHAPES)
def test_m1_matches_its_plain_versions_at_odd_shapes(cuda_no_tf32, m, k, n):
    """M1's three uses against their plain versions (the same bf16 values
    multiplied in f32, terms summed smallest first) at shapes the cascade
    does not have: within 1e-5 by norm (summation order)."""
    from recurrent_gaze_prediction_tpu_torch.ops import layers
    from recurrent_gaze_prediction_tpu_torch.ops.kernels import gemm

    g = torch.Generator(device=cuda_no_tf32).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=cuda_no_tf32)
    w = torch.randn(k, n, generator=g, device=cuda_no_tf32) * 0.05
    cot = torch.randn(m, n, generator=g, device=cuda_no_tf32)
    ap = layers._padded(a, m, layers._up(k))
    wp = layers._padded(w, layers._up(k), layers._up(n))
    terms = layers.split_bf16(cot, wp.shape[1])
    pairs = [(gemm.forward(ap, wp, n), gemm.forward_plain(ap, wp, n)),
             (gemm.input_grad(terms, wp, k),
              gemm.input_grad_plain(terms, wp, k)),
             (gemm.weight_grad(ap, terms, k, n),
              gemm.weight_grad_plain(ap, terms, k, n))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _l2_rel(got, want) <= 1e-5, (got.shape, _l2_rel(got, want))


# The cascade's convs whose card route this file's M1 section gates: the
# bottom cell's hoisted input conv (3x3, 512 -> 768 over 1,176 7x7 frames;
# SAME pads now inside cuDNN) and the 11x11 stride-7 upsample (256 -> 64,
# 7x7 -> 49x49; `_TransposeConv`): (x shape, kernel HWIO, cotangent shape,
# weight std)
CONV_CASES = {
    "input_conv": ((1176, 7, 7, 512), (3, 3, 512, 768), (1176, 7, 7, 768),
                   0.015),
    "upsample": ((1176, 7, 7, 256), (11, 11, 256, 64), (1176, 49, 49, 64),
                 0.03)}
CONV_READINGS = ("y", "dx", "dw")


def _conv_call(name, x, w):
    from recurrent_gaze_prediction_tpu_torch.ops import layers

    bf = torch.bfloat16
    if name == "input_conv":
        return layers.conv2d(x, w, compute_dtype=bf, out_dtype=bf)
    return layers.conv2d_transpose(x, w, stride=7, padding="SAME",
                                   compute_dtype=bf, out_dtype=bf)


def _conv_f64(name, x, w, cot):
    """The f64 conv of the same bf16-rounded operands and its gradients."""
    import torch.nn.functional as F

    x64 = x.bfloat16().double().permute(0, 3, 1, 2).requires_grad_(True)
    w64 = w.bfloat16().double().requires_grad_(True)
    if name == "input_conv":
        y = F.conv2d(x64, w64.permute(3, 2, 0, 1), padding=1)
    else:
        y = F.conv_transpose2d(x64, w64.flip(0, 1).permute(2, 3, 0, 1),
                               stride=7)[:, :, 2:51, 2:51]
    dx, dw = torch.autograd.grad(y, (x64, w64),
                                 cot.double().permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1), dw


def _conv_run(name, x, w, cot, chunks=1):
    """The conv through the port's route and its gradients (y, dx, dw). With
    `chunks` > 1 (the control) each reduction is cut in that many parts,
    each part's result rounded to bf16 and the parts added in bf16: y's
    and dx's over the input and output channels, dw's over the frames."""
    bf = torch.bfloat16

    def grads(xx, ww, cc):
        xx = xx.detach().requires_grad_(True)
        ww = ww.detach().requires_grad_(True)
        y = _conv_call(name, xx, ww)
        dx, dw = torch.autograd.grad(y, (xx, ww), cc)
        return y, dx, dw.to(bf)

    if chunks == 1:
        return grads(x, w, cot)
    cin, cout, n = w.shape[2], w.shape[3], x.shape[0]
    y = dx = dw = None
    for c in range(chunks):
        i = slice(c * cin // chunks, (c + 1) * cin // chunks)
        o = slice(c * cout // chunks, (c + 1) * cout // chunks)
        f = slice(c * n // chunks, (c + 1) * n // chunks)
        part_y = _conv_call(name, x[..., i], w[:, :, i, :])
        part_dx = grads(x, w[..., o], cot[..., o])[1]
        part_dw = grads(x[f], w, cot[f])[2]
        y = part_y if y is None else y + part_y
        dx = part_dx if dx is None else dx + part_dx
        dw = part_dw if dw is None else dw + part_dw
    return y, dx, dw


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_cascade_convs_within_twice_the_parent_route_error(cuda_no_tf32,
                                                            monkeypatch,
                                                            name, seed):
    """The input conv and the upsample in bf16 on the card, forward and
    both gradients, against the f64 conv of the same rounded operands:
    each within 2x of the route it replaces (F.pad before the conv; the
    full transposed conv cut by views); the control, the same route with
    its sums cut in 16 parts each rounded to bf16, is refused."""
    from recurrent_gaze_prediction_tpu_torch.ops import layers

    xs, ws, cs, std = CONV_CASES[name]
    g = torch.Generator(device=cuda_no_tf32).manual_seed(seed)
    x = torch.randn(xs, generator=g, device=cuda_no_tf32)
    x = (x if name == "input_conv" else torch.tanh(x)).bfloat16()
    w = torch.randn(ws, generator=g, device=cuda_no_tf32) * std
    cot = torch.randn(cs, generator=g, device=cuda_no_tf32).bfloat16()
    want = _conv_f64(name, x, w, cot)
    new = _conv_run(name, x, w, cot)
    ctl = _conv_run(name, x, w, cot, chunks=16)
    if name == "input_conv":
        import torch.nn.functional as F

        def padded(xx, ww, **_):
            out = F.conv2d(F.pad(xx.permute(0, 3, 1, 2), (1, 1, 1, 1)),
                           ww.bfloat16().permute(3, 2, 0, 1))
            return out.permute(0, 2, 3, 1)
        monkeypatch.setattr(layers, "conv2d", padded)
    else:
        monkeypatch.setattr(layers, "_transpose_crop", lambda *a: None)
    old = _conv_run(name, x, w, cot)
    monkeypatch.undo()
    torch.cuda.synchronize()
    readings = {r: (_l2_rel(a, b), _l2_rel(o, b), _l2_rel(c, b))
                for r, a, o, c, b in zip(CONV_READINGS, new, old, ctl, want)}
    print(f"conv {name} seed {seed}: " + ", ".join(
        f"{r} {v[0]:.4e} / parent {v[1]:.4e} (control {v[2]:.4e})"
        for r, v in readings.items()))
    for r, (got, parent, control) in readings.items():
        assert got <= 2 * parent, (r, readings)
        assert control > 2 * parent, (r, readings)
