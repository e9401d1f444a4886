"""The dense layers' bf16 products on the tensor cores (kernel M1's route,
`ops/layers._TensorCoreMatmul`) and the convs' cropping and padding routes
(`ops/layers._TransposeConv`, `conv2d`'s equal SAME pads), on the CPU: the three-term split of an f32
cotangent, the Function's algebra through M1's plain versions against
`matmul_f32`'s f32 products, `matmul_f32` on a CPU tensor as it was, the
split-K plan, the transposed conv's padded backward against autograd
of the cropped full conv, and both convs against the routes they replaced
(an `F.pad` copy; the full transposed conv cut by views). The kernel itself runs on the card
(`tests/test_torch_cuda.py -k m1`)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from recurrent_gaze_prediction_tpu_torch.ops import layers
from recurrent_gaze_prediction_tpu_torch.ops.kernels import gemm


def _rel(a: torch.Tensor, want: torch.Tensor) -> float:
    """||a - want|| / ||want|| (Frobenius), in f64."""
    a, want = a.detach().double(), want.detach().double()
    return float((a - want).norm() / want.norm())


def _spanning(rng, shape) -> torch.Tensor:
    """f32 values of both signs over binades 2^-90 .. 2^90 (lo stays
    normal), with random significands, and signed zeros."""
    mant = rng.uniform(1.0, 2.0, size=shape)
    exp = rng.randint(-90, 91, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape)
    g = torch.from_numpy((sign * mant * np.exp2(exp)).astype(np.float32))
    g.view(-1)[:4] = torch.tensor([0.0, -0.0, 0.0, -0.0])
    return g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16_is_exact(seed):
    """hi + mid + lo == g in f32, over many binades and signed zeros; each
    term is bf16, the columns past N are zero, and hi keeps the sign of a
    zero."""
    g = _spanning(np.random.RandomState(seed), (67, 45))
    terms = layers.split_bf16(g, 48)
    assert terms.dtype == torch.bfloat16 and terms.shape == (67, 3, 48)
    hi, mid, lo = (terms[:, i, :45].float() for i in range(3))
    assert torch.equal((lo + mid) + hi, g)
    assert torch.equal(hi + (mid + lo), g)
    assert not terms[:, :, 45:].any()
    assert torch.equal(torch.signbit(hi.view(-1)[:4]),
                       torch.tensor([False, True, False, True]))
    # the terms shrink: mid below half an ulp of hi, lo below half of mid's
    big = hi.abs() > 0
    assert bool((mid.abs()[big] <= hi.abs()[big] * 2.0 ** -8).all())


def _operands(seed, m, k, n):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(np.tanh(rng.randn(m, k)).astype(np.float32))
    b = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32))
    g = torch.from_numpy((rng.randn(m, n) * 1e-3).astype(np.float32))
    return a, b, g


# odd K and N, as fc1's 7203 -> 4802, so the operands are padded
SHAPES = [(37, 75, 53), (16, 64, 40), (1, 9, 3)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tensor_core_matmul_algebra_matches_matmul_f32(m, k, n):
    """The Function through M1's plain versions (bf16 products exact in
    f32): the forward equals `matmul_f32`'s f32 product, each gradient's
    f32 sums over the three terms equal the f32 product with the unrounded
    cotangent, within 1e-6 (Frobenius); the returned gradients are those
    sums rounded to bf16, in the operands' dtype."""
    a, b, g = _operands(m + k, m, k, n)
    bf = torch.bfloat16
    a16, b16 = a.to(bf).float(), b.to(bf).float()
    aa, bb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = layers._TensorCoreMatmul.apply(aa, bb)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert _rel(out, layers.matmul_f32(a, b, bf)) <= 1e-6
    da, db = torch.autograd.grad(out, (aa, bb), g)

    terms = layers.split_bf16(g, layers._up(n))
    b16p = layers._padded(b, layers._up(k), layers._up(n))
    a16p = layers._padded(a, m, layers._up(k))
    sums_a = gemm.input_grad_plain(terms, b16p, k)
    sums_b = gemm.weight_grad_plain(a16p, terms, k, n)
    assert _rel(sums_a, g @ b16.t()) <= 1e-6
    assert _rel(sums_b, a16.t() @ g) <= 1e-6
    assert da.dtype == db.dtype == torch.float32
    assert torch.equal(da, sums_a.to(bf).float())
    assert torch.equal(db, sums_b.to(bf).float())


def test_tensor_core_matmul_skips_what_needs_no_gradient():
    """An input without a gradient (the projection's features) gets none,
    and a bf16 input's gradient comes back in bf16."""
    a, b, g = _operands(5, 12, 24, 10)
    a = a.to(torch.bfloat16)
    bb = b.clone().requires_grad_(True)
    out = layers._TensorCoreMatmul.apply(a, bb)
    (db,) = torch.autograd.grad(out, (bb,), g)
    assert db.shape == b.shape
    ab = a.clone().requires_grad_(True)
    (da,) = torch.autograd.grad(layers._TensorCoreMatmul.apply(ab, b), (ab,),
                                g)
    assert da.dtype == torch.bfloat16 and da.shape == a.shape


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32, None])
def test_matmul_f32_on_the_cpu_is_unchanged(cdt):
    """On a CPU tensor `matmul_f32` multiplies f32 copies of the rounded
    operands (no Function, no kernel), its gradients those of the cast
    chain, bit for bit."""
    a, b, g = _operands(7, 9, 33, 17)
    aa, bb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = gemm.launches
    out = layers.matmul_f32(aa, bb, cdt)
    da, db = torch.autograd.grad(out, (aa, bb), g)
    r = (lambda x: x) if cdt is None else (lambda x: x.to(cdt))
    a_, b_ = r(a).float(), r(b).float()
    assert gemm.launches == before
    assert out.grad_fn.name() == "MmBackward0"
    assert torch.equal(out, torch.matmul(a_, b_))
    assert torch.equal(da, r(g @ b_.t()).float())
    assert torch.equal(db, r(a_.t() @ g).float())


def test_split_plan_fills_the_card_only_when_tiles_are_few():
    """The projection's weight gradient (1024 x 512: 32 tiles) splits its
    3 x 901 blocks over grid.z; fc1's products (hundreds of tiles) do not;
    no split takes fewer than four blocks."""
    blocks = 3 * -(-57624 // gemm.BLOCK)
    assert gemm._splits(1024, 512, blocks) == -(-gemm.SLOTS // 32)
    assert gemm._splits(1176, 4802, -(-7208 // gemm.BLOCK)) == 1
    assert gemm._splits(7203, 4802, 3 * -(-1176 // gemm.BLOCK)) == 1
    assert gemm._splits(64, 64, 6) == 1


# (input size, Cin, Cout, kernel, stride, padding): the cascade's upsample
# and gaze_grcn's decoder deconvs, shrunk in channels
TRANSPOSE_CASES = [(7, 8, 4, 11, 7, "SAME"), (7, 6, 5, 5, 3, "VALID"),
                   (9, 4, 3, 5, 2, "VALID"), (9, 4, 1, 7, 1, "SAME")]


@pytest.mark.parametrize("size,cin,cout,k,s,padding", TRANSPOSE_CASES)
def test_transpose_conv_padded_backward_matches_autograd(size, cin, cout, k,
                                                         s, padding):
    """`_TransposeConv` (the route: crop by the conv's padding, the
    backward on the stride-aligned cotangent) against autograd of the full
    transposed conv cut to the window `lax.conv_transpose` keeps, in f64:
    the output, both gradients."""
    crop = layers._transpose_crop(k, s, padding)
    assert crop is not None
    g = torch.Generator().manual_seed(size * k + s)
    x = torch.randn(2, cin, size, size, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(cin, cout, k, k, dtype=torch.float64, generator=g,
                    requires_grad=True)
    y = layers._TransposeConv.apply(x, w, s, (crop, crop))
    cot = torch.randn(y.shape, dtype=torch.float64, generator=g)
    got = torch.autograd.grad(y, (x, w), cot)
    full = F.conv_transpose2d(x, w, stride=s)
    want_y = full[:, :, crop:crop + y.shape[2], crop:crop + y.shape[3]]
    want = torch.autograd.grad(want_y, (x, w), cot)
    length = (size - 1) * s + 1 + sum(layers._transpose_pads(k, s,
                                                             padding)) - k + 1
    assert y.shape[2:] == (length, length)
    assert torch.allclose(y, want_y, rtol=1e-12, atol=1e-12)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def test_transpose_crop_refuses_a_window_that_pads():
    """A VALID transposed conv whose stride exceeds its kernel keeps more
    than the full conv (zero-extended): the cropping route refuses it."""
    assert layers._transpose_crop(2, 3, "VALID") is None
    assert layers._transpose_crop(11, 7, "SAME") == 2


# (input size, Cin, Cout, kernel, stride): SAME pads equal on both sides
# (odd kernels at stride 1: the ConvGRU / ConvLSTM state and input convs),
# and unequal ones (an even kernel, a stride of 2)
SAME_CASES = [(7, 6, 9, 3, 1), (9, 3, 4, 5, 1), (8, 3, 4, 4, 1),
              (9, 3, 4, 3, 2)]


@pytest.mark.parametrize("size,cin,cout,k,s", SAME_CASES)
def test_conv2d_same_pads_match_the_padded_copy(size, cin, cout, k, s):
    """`conv2d` under SAME against the conv of an `F.pad` copy (extra pad
    at the end), in f64: the output and both gradients."""
    g = torch.Generator().manual_seed(size * k + s)
    x = torch.randn(2, size, size, cin, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(k, k, cin, cout, dtype=torch.float64, generator=g,
                    requires_grad=True)
    y = layers.conv2d(x, w, stride=s, out_dtype=torch.float64)
    ph = layers._same_pads(size, k, s)
    want = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (*ph, *ph)),
                    w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)
    assert y.shape == want.shape
    assert torch.allclose(y, want, rtol=1e-12, atol=1e-12)
    cot = torch.randn(y.shape, dtype=torch.float64, generator=g)
    for a, b in zip(torch.autograd.grad(y, (x, w), cot),
                    torch.autograd.grad(want, (x, w), cot)):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("size,cin,cout,k,s,padding", TRANSPOSE_CASES)
def test_conv2d_transpose_matches_the_cut_full_conv(monkeypatch, size, cin,
                                                    cout, k, s, padding):
    """`conv2d_transpose` through `_TransposeConv` against the same call
    with the crop refused (the full transposed conv cut by views), in f64:
    the output and both gradients."""
    g = torch.Generator().manual_seed(size * k + s + 1)
    x = torch.randn(2, size, size, cin, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(k, k, cin, cout, dtype=torch.float64, generator=g,
                    requires_grad=True)

    def run():
        return layers.conv2d_transpose(x, w, stride=s, padding=padding,
                                       out_dtype=torch.float64)

    y = run()
    cot = torch.randn(y.shape, dtype=torch.float64, generator=g)
    got = torch.autograd.grad(y, (x, w), cot)
    monkeypatch.setattr(layers, "_transpose_crop", lambda *a: None)
    want_y = run()
    want = torch.autograd.grad(want_y, (x, w), cot)
    assert y.shape == want_y.shape
    assert torch.allclose(y, want_y, rtol=1e-12, atol=1e-12)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
