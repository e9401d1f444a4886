"""Kernel B6 (`ops/kernels/convgru_grid.py`) on the CPU: its plain forward
and backward against `ConvGRU.scan` under autograd (remat on and off) at
the cascade's bottom-cell width (U=256, 3x3, 7x7, B=2, T=3); the plain
backward against autograd of the plain forward at other grids; the rule
that decides which cells it takes (none that B1 or B5 takes); its
shared-memory reckoning; and the weight stream's fragment order.

f32: the plain versions and the scan make the same convs in the same
precision, so ys agrees bitwise and the gradients within 1e-5 of each
tensor's largest magnitude. bf16: they round at different points (the scan
rounds each conv's sum to bf16, and autograd each step's weight gradient;
B6's rule keeps both in f32), so the two agree within 2e-2 of each tensor's
largest magnitude, and B6's error against the f32 scan is at most 1.25x
the bf16 scan's plus 1e-3 of that magnitude.
"""

import random

import pytest
import torch

from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import build
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_grid as kg
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_small as ks
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp as v1

T, B, C, UNITS, HW = 3, 2, 32, 256, (7, 7)
NAMES = ["ys", "W_z", "U_z", "W_r", "U_r", "W", "U", "x", "h0"]


def _case(seed=0, units=UNITS, hw=HW, c=C, t=T, b=B):
    g = torch.Generator().manual_seed(seed)
    params = {n: (torch.randn(v.shape, generator=g) * 0.05).requires_grad_()
              for n, v in ConvGRU.init(c, units).items()}
    x = torch.randn(t, b, *hw, c, generator=g).requires_grad_()
    h0 = (0.3 * torch.randn(b, *hw, units, generator=g)).requires_grad_()
    cot = torch.randn(t, b, *hw, units, generator=g)
    return params, x, h0, cot


def _outputs(scan, case, cdt, **kw):
    """ys and the gradients of sum(ys * cot) wrt every param, x and h0."""
    params, x, h0, cot = case
    _, ys = scan(params, x, h0, compute_dtype=cdt, **kw)
    grads = torch.autograd.grad((ys * cot).sum(), [*params.values(), x, h0])
    return [ys.detach(), *grads]


def _rel(a, b, scale):
    return float((a.float() - b.float()).abs().max()) / scale


@pytest.mark.parametrize("remat", [False, True])
def test_plain_versions_match_the_scan_in_f32(remat):
    case = _case()
    want = _outputs(ConvGRU.scan, case, torch.float32, remat=remat)
    got = _outputs(kg.convgru_scan_grid, case, torch.float32)
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w, float(w.abs().max())) <= 1e-5, name


@pytest.mark.parametrize("remat", [False, True])
def test_plain_versions_match_the_scan_in_bf16(remat):
    case = _case(seed=1)
    f32 = _outputs(ConvGRU.scan, case, torch.float32)
    scan = _outputs(ConvGRU.scan, case, torch.bfloat16, remat=remat)
    grid = _outputs(kg.convgru_scan_grid, case, torch.bfloat16)
    for name, s, k, r in zip(NAMES, scan, grid, f32):
        scale = float(r.abs().max())
        assert _rel(k, s, scale) <= 2e-2, name
        assert _rel(k, r, scale) <= 1.25 * _rel(s, r, scale) + 1e-3, name


@pytest.mark.parametrize("units,hw", [(128, (5, 6)), (256, (3, 4)),
                                      (64, (1, 9))])
def test_plain_backward_is_the_recursion_autograd_takes(units, hw):
    """`backward` (the recursion on the forward's gates, then phase W's
    plain version) against autograd through `forward_plain` in f32, at
    other widths and grids than the cascade's."""
    params, x, h0, cot = _case(seed=2, units=units, hw=hw, c=5, t=4)
    fused = ConvGRU.fuse(params)
    wx = ConvGRU.input_gates(fused, x.detach()).requires_grad_()
    uzr = fused["Uh_zr"].detach().requires_grad_()
    uc = fused["U_c"].detach().requires_grad_()
    h = h0.detach().requires_grad_()
    ys, _ = kg.forward_plain(uzr, uc, wx, h)
    want = torch.autograd.grad((ys * cot).sum(), [wx, h, uzr, uc])
    with torch.no_grad():
        ys, gates = kg.forward_plain(uzr, uc, wx, h, keep_gates=True)
        got = kg.backward(uzr, uc, wx, h, ys, gates, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


def test_the_gates_are_the_forward_s():
    """`forward_plain` keeps u, r and c as the step computes them: h' =
    u h + (1 - u) c from the kept gates gives ys."""
    params, x, h0, _ = _case(seed=3)
    fused = ConvGRU.fuse({n: p.detach() for n, p in params.items()})
    wx = ConvGRU.input_gates(fused, x.detach())
    ys, gates = kg.forward_plain(fused["Uh_zr"], fused["U_c"], wx,
                                 h0.detach(), keep_gates=True)
    assert kg.forward_plain(fused["Uh_zr"], fused["U_c"], wx,
                            h0.detach())[1] is None
    u, _, c = gates
    hprev = kconv.hprev_of(h0.detach(), ys)
    torch.testing.assert_close(u * hprev + (1 - u) * c, ys, rtol=0,
                               atol=1e-6)


SHAPES = [(h, w) for h in range(1, 11) for w in range(1, 11)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_no_shape_b1_or_b5_takes(dtype):
    """Over grids up to 10x10, widths 16..512 and 3x3 / 5x5 kernels: B6
    takes no shape that B1 or B5 takes, and in bf16 only U=256 and only
    grids whose H x (W+2) rows fit 64 (the cascade's 7x7 among them)."""
    taken = set()
    for hw in SHAPES:
        for units in range(16, 513, 16):
            for kernel in ((3, 3), (5, 5)):
                grid = kg.kernel_takes(*hw, units, dtype, kernel)
                if grid:
                    taken.add((hw, units, kernel))
                    assert not kconv.kernel_takes(*hw, units, dtype, kernel)
                    assert not ks.kernel_takes(*hw, units, dtype, kernel)
    if dtype == torch.float32:
        assert taken == set()
        return
    assert ((7, 7), 256, (3, 3)) in taken
    assert {u for _, u, _ in taken} == {256}
    assert {k for _, _, k in taken} == {(3, 3)}
    assert all(h * (w + 2) <= kg.ROWS for (h, w), _, _ in taken)
    assert not kg.kernel_takes(8, 7, 256, dtype)     # 72 rows
    assert not kg.kernel_takes(7, 7, 128, dtype)     # B1's
    assert not kg.kernel_takes(7, 7, 384, dtype)     # not built


def test_kernel_takes_is_a_pure_function_of_the_shapes(monkeypatch):
    """The rule reads nothing but its arguments: no build, no card."""
    def no_card(*_):
        raise AssertionError("kernel_takes touched the build")

    monkeypatch.setattr(build, "load", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    answers = [kg.kernel_takes(7, 7, 256, torch.bfloat16) for _ in range(3)]
    assert answers == [True] * 3


def test_smem_reckoning():
    """The CTA's shared memory as `csrc/convgru_grid.cu` lays it out at
    the bottom cell: the ring's four 16 KB stages, one (forward) or two
    (backward) padded operands of 84 rows of 264 bf16 (44,352 B, 44,416
    aligned), eight barriers."""
    assert kg.smem_bytes(7, 7, 256, 1) == 65536 + 44416 + 64 == 110016
    assert kg.smem_bytes(7, 7, 256, 2) == 65536 + 2 * 44416 + 64 == 154432
    assert kg.smem_bytes(7, 7, 256, 2) <= kconv.SMEM_LIMIT
    # a 5x6 grid: 64 + 2*8 + 2 = 82 rows
    assert kg.pad_bytes(5, 6, 256) == kconv.align128(82 * 264 * 2)


def test_stream_is_in_fragment_order():
    """`pack_stream`'s stages as the kernel reads them: for channel slice
    s, phase 1's k-step ks, warp w and lane 4g + c hold w1's then w2's
    B[16ks+2c+{0,1}][n], B[16ks+2c+8+{0,1}][n] at n = 64s + 8w + g;
    phase 2's k-step pair kp holds w3's fragments of k-steps 2kp and
    2kp+1."""
    units = 256
    g = torch.Generator().manual_seed(0)
    w1, w2, w3 = (torch.randn(3, 3, units, units, generator=g)
                  for _ in range(3))
    stream = kg.pack_stream(w1, w2, w3)
    slices, ks_n = units // kg.SLICE, 9 * units // 16
    assert stream.dtype == torch.bfloat16
    assert stream.shape == (slices, 54 * kg.STAGE_BYTES // 2)
    first = ks_n * 8 * 32 * 8
    p1 = stream[:, :first].reshape(slices, ks_n, 8, 32, 8)
    p2 = stream[:, first:].reshape(slices, ks_n // 2, 8, 32, 8)
    mats = [w.to(torch.bfloat16).reshape(9 * units, units)
            for w in (w1, w2, w3)]
    rng = random.Random(1)
    for _ in range(500):
        s, w, lane = rng.randrange(slices), rng.randrange(8), rng.randrange(32)
        v, ks_ = rng.randrange(8), rng.randrange(ks_n)
        n, c = 64 * s + 8 * w + lane // 4, lane % 4
        row = 2 * c + 8 * ((v % 4) // 2) + v % 2
        assert p1[s, ks_, w, lane, v] == mats[v // 4][16 * ks_ + row, n]
        kp = ks_ // 2
        assert p2[s, kp, w, lane, v] == mats[2][16 * (2 * kp + v // 4) + row,
                                                 n]


def test_backward_stream_is_the_transposed_convs():
    """The recursion's stream packs transposed_weight(U_c), then the z and
    r halves of transposed_weight(U_zr)."""
    g = torch.Generator().manual_seed(1)
    uzr = torch.randn(3, 3, 128, 256, generator=g)
    uc = torch.randn(3, 3, 128, 128, generator=g)
    t = kconv.transposed_weight
    assert torch.equal(kg.backward_stream(uzr, uc), kg.pack_stream(
        t(uc), t(uzr)[:, :, :128], t(uzr)[:, :, 128:]))
    assert torch.equal(kg.forward_stream(uzr, uc), kg.pack_stream(
        uzr[..., :128], uzr[..., 128:], uc))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    params, x, h0, _ = _case(t=1, b=1)
    fused = ConvGRU.fuse({n: p.detach() for n, p in params.items()})
    wx = ConvGRU.input_gates(fused, x.detach(), torch.float32)
    with pytest.raises(ValueError, match="convgru_grid takes"):
        kg._check(fused["Uh_zr"], fused["U_c"], wx, h0.detach())
    with pytest.raises(ValueError, match="no grid ConvGRU kernel"):
        kg.recurrence(fused["Uh_zr"], fused["U_c"], wx.to("meta"),
                      h0.detach())


def test_the_scan_keeps_gates_only_for_a_backward(monkeypatch):
    """`convgru_scan_grid` asks the forward for the gates only where a
    backward can follow."""
    asked = []
    forward = kg.forward_plain

    def spy(*args, **kw):
        asked.append(args[4] if len(args) > 4 else kw.get("keep_gates"))
        return forward(*args, **kw)

    monkeypatch.setattr(kg, "forward_plain", spy)
    params, x, h0, _ = _case(t=2, b=1)
    kg.convgru_scan_grid(params, x, h0)
    with torch.no_grad():
        kg.convgru_scan_grid(params, x, h0)
    frozen = {n: p.detach() for n, p in params.items()}
    kg.convgru_scan_grid(frozen, x.detach(), h0.detach())
    assert asked == [True, False, False]


def test_phase_w_takes_the_bottom_cell():
    """The weight gradients go through phase W, whose rule takes the
    bottom cell (bf16, 7x7, U=256)."""
    assert v1.wgrad_takes(7, 7, 256, 2)
