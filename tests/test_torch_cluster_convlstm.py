"""The slicing that the cluster-split kernel B3 (`csrc/convlstm_fwd.cu`)
relies on, on the CPU.

B3 runs one batch element on a cluster of C CTAs: CTA k owns the channels
[k*Ns, (k+1)*Ns) and the i, f, c and o output columns of those channels
(`column_slices(Wh, C, groups=4)`) in one sum over the conv's depth,
updates its own slice of c, and every CTA gathers the new h. Here that
computation is written out slice by slice in PyTorch and held against
the plain version (`ConvLSTM.step_precomputed`) and the JAX package's
Pallas kernel in interpret mode, in f32 at rtol 1e-4 / atol 1e-5 (the JAX
package's kernel tolerance). The column order, the packing into mma
fragment order and the shared-memory reckoning are pinned too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.pallas.convlstm import (
    convlstm_scan_pallas as j_convlstm_scan_pallas)
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvLSTM
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convlstm as klstm
from recurrent_gaze_prediction_tpu_torch.ops.kernels.convgru import (
    cluster_size, column_slices, fragment_order, pack_slices)
from recurrent_gaze_prediction_tpu_torch.ops.layers import conv2d

TOL = dict(rtol=1e-4, atol=1e-5)
# (U, C): each width on the cluster the kernel gives it, Ns = 16 channels
CLUSTERS = [(16, 1), (32, 2), (48, 3), (128, 8)]


def _conv(x, w_slice):
    """SAME conv with one CTA's slice [9, K, N]."""
    return conv2d(x, w_slice.reshape(3, 3, *w_slice.shape[1:]))


def cluster_step(fused, carry, gx, clusters):
    """One ConvLSTM step as kernel B3 computes it on a cluster."""
    c, h = carry
    units = fused["W_ci"].shape[-1]
    ns = units // clusters
    w = column_slices(fused["Wh"], clusters, groups=klstm.GATES)
    pre = torch.split(gx, units, dim=-1)  # i, f, c, o
    new_c, new_h = [], []
    for k in range(clusters):
        own = slice(k * ns, (k + 1) * ns)
        g = _conv(h, w[k])  # the CTA's i|f|c|o columns
        gi, gf, gc, go = (pre[j][..., own] + g[..., j * ns:(j + 1) * ns]
                          for j in range(klstm.GATES))
        ck = c[..., own]  # the CTA's own slice of c
        i = torch.sigmoid(gi + fused["W_ci"][..., own] * ck)
        f = torch.sigmoid(gf + fused["W_cf"][..., own] * ck)
        nc = f * ck + i * torch.tanh(gc)
        o = torch.sigmoid(go + fused["W_co"][..., own] * ck)
        new_c.append(nc)
        new_h.append(torch.tanh(nc) * o)
    return torch.cat(new_c, dim=-1), torch.cat(new_h, dim=-1)  # gather h'


def cluster_scan(fused, gx_all, carry, clusters):
    ys = []
    for gx in gx_all:
        carry = cluster_step(fused, carry, gx, clusters)
        ys.append(carry[1])
    return carry, torch.stack(ys)


def _params(rng, c, units, scale=0.3):
    shapes = {k: v.shape for k, v in ConvLSTM.init(c, units).items()}
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("units,clusters", CLUSTERS)
def test_step_from_slices_matches_plain(units, clusters):
    assert cluster_size(units) == clusters
    rng = np.random.RandomState(units)
    fused = ConvLSTM.fuse({k: torch.from_numpy(v)
                           for k, v in _params(rng, 8, units, 0.1).items()})
    carry = (_f32(rng, 2, 7, 7, units, scale=0.5),
             _f32(rng, 2, 7, 7, units, scale=0.5))
    gx = _f32(rng, 2, 7, 7, 4 * units)
    (want_c, want_h), _ = ConvLSTM.step_precomputed(fused, carry, gx)
    got_c, got_h = cluster_step(fused, carry, gx, clusters)
    np.testing.assert_allclose(got_c.numpy(), want_c.numpy(), **TOL)
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), **TOL)


def test_cluster_scan_matches_jax_pallas_interpret():
    """The sliced recurrence from nonzero carries against the Pallas kernel
    in interpret mode on the same precomputed gates, on an odd grid."""
    t, b, units, hw = 3, 2, 32, (5, 9)
    rng = np.random.RandomState(40)
    params = _params(rng, 8, units)
    params.update({k: (rng.randn(*hw, units) * 0.3).astype(np.float32)
                   for k in ("W_ci", "W_cf", "W_co")})
    gx = rng.randn(t, b, *hw, 4 * units).astype(np.float32)
    c0, h0 = ((rng.randn(b, *hw, units) * 0.5).astype(np.float32)
              for _ in range(2))
    ys_j = j_convlstm_scan_pallas({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(gx),
                                  jnp.asarray(c0), jnp.asarray(h0),
                                  interpret=True)
    fused = ConvLSTM.fuse({k: torch.from_numpy(v) for k, v in params.items()})
    (_, h_t), ys_t = cluster_scan(fused, torch.from_numpy(gx),
                                  (torch.from_numpy(c0), torch.from_numpy(h0)),
                                  clusters=cluster_size(units))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(ys_j)[-1], **TOL)


def test_column_slices_hold_each_ctas_gate_columns():
    """CTA k's 4 Ns columns are the i, f, c and o columns of its channels,
    gate by gate: the order in which the kernel reads its partial sums."""
    units, clusters = 48, 3
    ns = units // clusters
    kernel = _f32(np.random.RandomState(41), 3, 3, 16, 4 * units)
    slices = column_slices(kernel, clusters, groups=4)
    assert slices.shape == (clusters, 9, 16, 4 * ns)
    for k in range(clusters):
        for gate in range(4):
            want = kernel.reshape(9, 16, -1)[
                ..., gate * units + k * ns:gate * units + (k + 1) * ns]
            assert torch.equal(slices[k, ..., gate * ns:(gate + 1) * ns],
                               want)


def test_pack_slices_bf16_is_the_mma_fragment_order():
    """The bf16 slices the wrapper packs: lane l = 4g + c of k-step s and
    column pair q holds rows 16s + 2c, +1, +8, +9 of column 16q + g, then
    of column 16q + 8 + g (mma.m16n8k16's b0, b1 of two n8 tiles), and f32
    stays plain."""
    units, clusters = 32, 2
    kernel = _f32(np.random.RandomState(42), 3, 3, units, 4 * units)
    packed = pack_slices(kernel, clusters, torch.bfloat16, groups=4)
    slices = column_slices(kernel.to(torch.bfloat16), clusters, groups=4)
    n = 4 * units // clusters
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (clusters, 9 * units // 16, n // 16, 32, 8)
    assert torch.equal(packed, fragment_order(slices))
    for cta in range(clusters):
        w = slices[cta].reshape(9 * units, n)
        for s in (0, 7, 17):
            for q in range(n // 16):
                for lane in range(32):
                    g, c = divmod(lane, 4)
                    rows = [16 * s + 2 * c + d for d in (0, 1, 8, 9)]
                    want = torch.cat([w[rows, 16 * q + 8 * tile + g]
                                      for tile in (0, 1)])
                    assert torch.equal(packed[cta, s, q, lane], want)
    assert torch.equal(pack_slices(kernel, clusters, torch.float32, groups=4),
                       column_slices(kernel, clusters, groups=4))


# Shared memory per CTA at 7x7, U=128, as the source's header reckons it
RECKONED = {2: 227456, 4: 138112}


@pytest.mark.parametrize("units", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("elem", [2, 4])
def test_shared_memory_reckoning_fits(units, elem):
    need = klstm.smem_bytes(7, 7, units, elem)
    if units == 128:
        assert need == RECKONED[elem]
    assert need <= kconv.SMEM_LIMIT
    kconv.check_fits("convlstm_fwd", need, 7, 7, units)
    ns = units // cluster_size(units)
    if elem == 2:
        # bf16 keeps the weight slice resident: 9 taps x U x 4 Ns values;
        # beside it and the two hpads, a second k-group plane of partial
        # sums would not fit at U=128
        assert need >= 9 * units * 4 * ns * 2
        assert 9 * 128 * 4 * 16 * 2 == 147456
        plane = kconv.acc_bytes(7, 7, 4 * ns, 2, 1)
        assert (need + plane > kconv.SMEM_LIMIT) == (units == 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_width_whose_slice_does_not_fit_raises_before_any_launch(dtype):
    """U=256 on clusters of 8: in bf16 the weight slice (589,824 B) cannot
    be resident; in f32, where it is read from global memory, the two
    hpads (2 x 88,704 B) and the rest still pass the limit. The wrapper
    raises from its own reckoning, before it builds or launches anything
    (here on CPU tensors, which would otherwise never reach this check)."""
    units, elem = 256, {torch.bfloat16: 2, torch.float32: 4}[dtype]
    need = klstm.smem_bytes(7, 7, units, elem)
    assert need > kconv.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kconv.check_fits("convlstm_fwd", need, 7, 7, units)
    rng = np.random.RandomState(43)
    fused = ConvLSTM.fuse({k: torch.from_numpy(v)
                           for k, v in _params(rng, 8, units).items()})
    gx = torch.zeros(1, 1, 7, 7, 4 * units, dtype=dtype)
    c0 = h0 = torch.zeros(1, 7, 7, units)
    before = klstm.launches
    with pytest.raises(ValueError, match="shared memory"):
        klstm._launch(fused, gx, c0, h0)
    assert klstm.launches == before
