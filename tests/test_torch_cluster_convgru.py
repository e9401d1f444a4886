"""The slicing that the cluster-split kernels B1 (`csrc/convgru_fwd.cu`) and
B2 (`csrc/convgru_bwd.cu`) rely on, on the CPU.

Each kernel runs one batch element on a cluster of C CTAs: CTA k owns the
output channels [k*Ns, (k+1)*Ns), convolves the whole gathered operand with
its column slices of the weights (`column_slices`), and its slice of the
next operand is gathered by every CTA. Here that computation is written out
slice by slice in PyTorch and held against the plain versions
(`ConvGRU.step_precomputed`, `dh_bwd_plain`) and the JAX package's Pallas
kernels in interpret mode, in f32 at rtol 1e-4 / atol 1e-5 (the JAX
package's kernel tolerance). The packing into mma fragment order, the
cluster-size rule and the shared-memory reckoning are pinned too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.ops.cells import ConvGRU as JConvGRU
from recurrent_gaze_prediction_tpu.ops.pallas import convgru_vjp2 as jv2
from recurrent_gaze_prediction_tpu.ops.pallas.convgru import (
    convgru_scan as j_convgru_scan)
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.ops.cells import ConvGRU
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru as kconv
from recurrent_gaze_prediction_tpu_torch.ops.kernels import convgru_vjp2 as v2
from recurrent_gaze_prediction_tpu_torch.ops.kernels.convgru import (
    cluster_size, column_slices, fragment_order, pack_slices,
    transposed_weight)
from recurrent_gaze_prediction_tpu_torch.ops.layers import conv2d

TOL = dict(rtol=1e-4, atol=1e-5)
UNITS = 24  # divisible by every cluster size tested


def _conv(x, w_slice):
    """SAME conv with one CTA's slice [9, K, N]."""
    return conv2d(x, w_slice.reshape(3, 3, *w_slice.shape[1:]))


def cluster_step(fused, h, wx, clusters):
    """One ConvGRU step as kernel B1 computes it on a cluster."""
    units = fused["U_c"].shape[-1]
    ns = units // clusters
    wzr = column_slices(fused["Uh_zr"], clusters, groups=2)
    wc = column_slices(fused["U_c"], clusters)
    own = [slice(k * ns, (k + 1) * ns) for k in range(clusters)]
    wz, wr, wcand = torch.split(wx, units, dim=-1)
    us, rhs = [], []
    for k in range(clusters):
        uh = _conv(h, wzr[k])  # the CTA's z and r columns
        us.append(torch.sigmoid(wz[..., own[k]] + uh[..., :ns]))
        r = torch.sigmoid(wr[..., own[k]] + uh[..., ns:])
        rhs.append(r * h[..., own[k]])
    rh = torch.cat(rhs, dim=-1)  # every CTA gathers r*h
    new = []
    for k in range(clusters):
        c = torch.tanh(wcand[..., own[k]] + _conv(rh, wc[k]))
        new.append(us[k] * h[..., own[k]] + (1.0 - us[k]) * c)
    return torch.cat(new, dim=-1)  # every CTA gathers h'


def cluster_scan(fused, wx_all, h0, clusters):
    h, ys = h0, []
    for wx in wx_all:
        h = cluster_step(fused, h, wx, clusters)
        ys.append(h)
    return h, torch.stack(ys)


def cluster_dh_bwd(u, r, c, hprev, g, uzr, uc, clusters):
    """The reverse-time recursion as kernel B2 computes it on a cluster:
    -> (dzr, da, dh0)."""
    units = uc.shape[-1]
    ns = units // clusters
    uct = column_slices(transposed_weight(uc), clusters)
    uzrt = column_slices(transposed_weight(uzr), clusters)
    own = [slice(k * ns, (k + 1) * ns) for k in range(clusters)]
    dh = torch.zeros_like(hprev[0])
    dzrs, das = [], []
    for t in reversed(range(u.shape[0])):
        ut, rt, ct, hp = u[t], r[t], c[t], hprev[t]
        dhn = [g[t][..., o] + dh[..., o] for o in own]
        dup = [d * (hp[..., o] - ct[..., o]) * ut[..., o] * (1.0 - ut[..., o])
               for d, o in zip(dhn, own)]
        da = torch.cat([d * (1.0 - ut[..., o]) * (1.0 - ct[..., o] ** 2)
                        for d, o in zip(dhn, own)], dim=-1)  # gather da
        drp, dh_own = [], []
        for k, o in enumerate(own):
            drh = _conv(da, uct[k])
            drp.append(drh * hp[..., o] * rt[..., o] * (1.0 - rt[..., o]))
            dh_own.append(dhn[k] * ut[..., o] + drh * rt[..., o])
        dzr = torch.cat(dup + drp, dim=-1)  # gather [du_pre | dr_pre]
        dh = torch.cat([d + _conv(dzr, uzrt[k]) for k, d in enumerate(dh_own)],
                       dim=-1)
        dzrs.append(dzr)
        das.append(da)
    return torch.stack(dzrs[::-1]), torch.stack(das[::-1]), dh


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _fused(rng, units=UNITS):
    return {"Uh_zr": _f32(rng, 3, 3, units, 2 * units, scale=0.3),
            "U_c": _f32(rng, 3, 3, units, units, scale=0.3)}


def _gates(rng, shape):
    u, r = (torch.sigmoid(_f32(rng, *shape)) for _ in range(2))
    return [u, r, torch.tanh(_f32(rng, *shape)), _f32(rng, *shape, scale=0.5),
            _f32(rng, *shape)]


@pytest.mark.parametrize("clusters", [1, 2, 3, 8])
def test_forward_step_from_slices_matches_plain(clusters):
    rng = np.random.RandomState(clusters)
    fused = _fused(rng)
    h = _f32(rng, 2, 7, 7, UNITS, scale=0.5)
    wx = _f32(rng, 2, 7, 7, 3 * UNITS)
    want, _ = ConvGRU.step_precomputed(fused, h, wx)
    got = cluster_step(fused, h, wx, clusters)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("clusters", [1, 2, 3, 8])
def test_backward_steps_from_slices_match_plain(clusters):
    rng = np.random.RandomState(10 + clusters)
    fused = _fused(rng)
    streams = _gates(rng, (3, 2, 5, 9, UNITS))
    want = v2.dh_bwd_plain(*streams, fused["Uh_zr"], fused["U_c"])
    got = cluster_dh_bwd(*streams, fused["Uh_zr"], fused["U_c"], clusters)
    for name, k, a in zip(("dzr", "da", "dh0"), got, want):
        np.testing.assert_allclose(k.numpy(), a.numpy(), err_msg=name, **TOL)


def test_cluster_scan_matches_jax_pallas_interpret():
    """Weights made by the JAX package, carried across by the bridge; the
    sliced recurrence against the Pallas kernel in interpret mode."""
    t, b, c = 3, 2, 8
    jparams = JConvGRU.init(jax.random.PRNGKey(0), c, UNITS, stddev=0.3)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.RandomState(20)
    xs = rng.randn(t, b, 7, 7, c).astype(np.float32)
    h0 = (rng.randn(b, 7, 7, UNITS) * 0.5).astype(np.float32)
    h_j, ys_j = j_convgru_scan(jparams, jnp.asarray(xs), jnp.asarray(h0),
                               compute_dtype=jnp.float32, interpret=True)
    fused = ConvGRU.fuse(params)
    wx = ConvGRU.input_gates(fused, torch.from_numpy(xs))
    h_t, ys_t = cluster_scan(fused, wx, torch.from_numpy(h0), clusters=3)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)


def test_cluster_dh_bwd_matches_jax_pallas_interpret():
    jfused = JConvGRU.fuse(JConvGRU.init(jax.random.PRNGKey(1), 8, UNITS,
                                         stddev=0.3))
    fused = params_from_jax(jax.tree_util.tree_map(np.asarray, jfused))
    streams = _gates(np.random.RandomState(21), (3, 1, 7, 7, UNITS))
    want = jv2._dh_bwd_pallas(*(jnp.asarray(x.numpy()) for x in streams),
                              jfused["Uh_zr"], jfused["U_c"], interpret=True)
    got = cluster_dh_bwd(*streams, fused["Uh_zr"], fused["U_c"], clusters=2)
    for name, k, a in zip(("dzr", "da", "dh0"), got, want):
        np.testing.assert_allclose(k.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_column_slices_hold_each_ctas_columns(groups):
    rng = np.random.RandomState(30)
    kernel = _f32(rng, 3, 3, 16, groups * UNITS)
    slices = column_slices(kernel, 3, groups)
    ns = UNITS // 3
    assert slices.shape == (3, 9, 16, groups * ns)
    for k in range(3):
        cols = [gi * UNITS + k * ns + j for gi in range(groups)
                for j in range(ns)]
        want = kernel.reshape(9, 16, -1)[..., cols]
        assert torch.equal(slices[k], want)


def test_fragment_order_is_the_mma_b_fragment_layout():
    """Lane l = 4g + c of k-step s and column pair q holds, for n = 16q + g
    and then n = 16q + 8 + g, the rows 16s + 2c, +1, +8, +9 of the [9K, N]
    slice: mma.m16n8k16's b0, b1 registers of two n8 tiles."""
    rng = np.random.RandomState(31)
    slices = _f32(rng, 2, 9, 32, 32)
    packed = fragment_order(slices)
    assert packed.shape == (2, 18, 2, 32, 8)
    for cta in range(2):
        w = slices[cta].reshape(9 * 32, 32)
        for s in range(18):
            for q in range(2):
                for lane in range(32):
                    g, c = divmod(lane, 4)
                    rows = [16 * s + 2 * c + d for d in (0, 1, 8, 9)]
                    want = torch.cat([w[rows, 16 * q + 8 * tile + g]
                                      for tile in (0, 1)])
                    assert torch.equal(packed[cta, s, q, lane], want)


def test_pack_slices_orders_bf16_and_keeps_f32_plain():
    rng = np.random.RandomState(32)
    kernel = _f32(rng, 3, 3, 16, 2 * 32)
    f32 = pack_slices(kernel, 2, torch.float32, groups=2)
    assert torch.equal(f32, column_slices(kernel, 2, groups=2))
    bf16 = pack_slices(kernel, 2, torch.bfloat16, groups=2)
    assert bf16.dtype == torch.bfloat16 and bf16.is_contiguous()
    assert torch.equal(bf16, fragment_order(
        column_slices(kernel.to(torch.bfloat16), 2, groups=2)))


@pytest.mark.parametrize("units,clusters", [
    (16, 1), (32, 2), (48, 3), (64, 4), (80, 5), (96, 6), (112, 7),
    (128, 8), (144, 3), (256, 8)])
def test_cluster_size_rule(units, clusters):
    assert cluster_size(units) == clusters
    assert units % (16 * clusters) == 0


# Shared memory per CTA at 7x7, as the sources' headers reckon it
RECKONED = {("fwd", 128, 2): 213248, ("fwd", 128, 4): 126848,
            ("bwd", 128, 2): 221440, ("bwd", 128, 4): 159488}


@pytest.mark.parametrize("units", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("elem", [2, 4])
def test_shared_memory_reckoning_fits_each_cluster(units, kernel, elem):
    smem = {"fwd": kconv.smem_bytes, "bwd": v2.smem_bytes}[kernel]
    need = smem(7, 7, units, elem)
    assert need == RECKONED.get((kernel, units, elem), need)
    assert need <= kconv.SMEM_LIMIT
    kconv.check_fits(kernel, need, 7, 7, units)
    if elem == 2:
        # bf16 keeps the weight slices resident: 9 taps x 3U x Ns values
        # (B1: U_zr's 2 Ns columns and U_c's Ns over U inputs; B2: U_c^T's
        # Ns columns over U inputs and U_zr^T's over 2U)
        ns = units // cluster_size(units)
        assert need >= 9 * 3 * units * ns * 2
        assert 9 * 3 * 128 * 16 * 2 == 110592


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("elem", [2, 4])
def test_a_width_whose_slice_does_not_fit_raises(kernel, elem):
    smem = {"fwd": kconv.smem_bytes, "bwd": v2.smem_bytes}[kernel]
    need = smem(7, 7, 256, elem)
    assert need > kconv.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kconv.check_fits(kernel, need, 7, 7, 256)
