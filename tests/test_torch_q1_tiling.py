"""What surrounds kernel Q1 (`csrc/conv3d_int8.cu`) on the CPU: the tile
plan the wrapper launches it with, and numpy emulations of its two routes
and its requant step, held to the plain version and to the JAX package.

  * `tile_plan`'s boxes of 128 output positions cover every position of
    each tower layer, and of ragged shapes, exactly once, with at most 25%
    of a tower layer's computed rows past its volume;
  * the "wgmma" route (Cin a multiple of 64): box-tiled, tap-shifted
    implicit GEMM, one (tap, channel chunk) K step at a time, A read as a
    TMA box load reads it (zeros at coordinates outside the volume,
    negative ones included), B the packed weights' [BN, BK] slice, the
    boxes numbered as the kernel's grid numbers them; equal to
    `conv3d_int32_plain` and to JAX's `_conv3d_int8` bit for bit;
  * the "halo" route (Cin <= 4, conv1a): the box's halo staged as one
    32-bit word per position, each mma A-fragment register read straight
    from it at the row's and tap's offsets (taps past 26 read any word and
    meet zero weights); equal to `conv3d_int32_plain`;
  * the epilogue's requant estimate (y times the scale's reciprocal, the
    division only near a rounding tie) equal to the plain `quantize`,
    ties and their neighbours included, and the halo route's int -> float
    of its small sums through the magic number exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.models import quant as jquant
from recurrent_gaze_prediction_tpu_torch.ops.kernels import conv3d_int8 as q1

# each tower layer's input D x H x W x Cin and Cout (16 x 112 x 112 clips)
TOWER = {"conv1a": ((16, 112, 112, 3), 64), "conv2a": ((16, 56, 56, 64), 128),
         "conv3a": ((8, 28, 28, 128), 256), "conv3b": ((8, 28, 28, 256), 256),
         "conv4a": ((4, 14, 14, 256), 512), "conv4b": ((4, 14, 14, 512), 512),
         "conv5a": ((2, 7, 7, 512), 512), "conv5b": ((2, 7, 7, 512), 512)}
RAGGED = [(5, 9, 13), (3, 5, 7), (1, 1, 1), (7, 11, 13), (6, 10, 18),
          (17, 3, 130), (2, 7, 7)]


def _cover(dhw, box) -> np.ndarray:
    """How many boxes (in the kernel's order) cover each position."""
    count = np.zeros(dhw, np.int64)
    for d0, h0, w0 in q1.box_origins(dhw, box):
        count[d0:d0 + box[0], h0:h0 + box[1], w0:w0 + box[2]] += 1
    return count


@pytest.mark.parametrize("layer", list(TOWER))
def test_tower_plans_cover_each_position_once(layer):
    (d, h, w, cin), cout = TOWER[layer]
    plan = q1.tile_plan((160, d, h, w, cin), cout)
    box = plan["box"]
    assert int(np.prod(box)) == q1.BOX_ROWS
    assert (_cover((d, h, w), box) == 1).all()
    assert q1.box_waste((d, h, w), box) <= 0.25
    if cin <= 4:
        assert plan["route"] == "halo" and plan["bn"] == 64
        assert plan["bk"] == q1.packed_k(cin) == 128 and plan["stages"] == 2
        assert q1.halo_words(box) <= q1.HALO_MAX
    else:
        assert plan["route"] == "wgmma" and cout % plan["bn"] == 0
        assert plan["bn"] == min(256, cout) and cin % plan["bk"] == 0
        stage = (q1.BOX_ROWS + plan["bn"]) * plan["bk"]
        budget = 200 if plan["bn"] == 256 else 100
        assert 4 <= plan["stages"] <= 6
        assert plan["stages"] * stage <= budget * 1024


@pytest.mark.parametrize("dhw", RAGGED)
def test_ragged_plans_cover_each_position_once(dhw):
    for cin in (3, 64, 128):
        box = q1.tile_plan((2, *dhw, cin), 128)["box"]
        assert int(np.prod(box)) == q1.BOX_ROWS
        assert (_cover(dhw, box) == 1).all()


def test_card_cases_are_ragged_in_every_dimension():
    """The card tests' ragged cases (tests/test_torch_cuda.py) leave part
    of a box past the volume along each of d, h and w."""
    for dhw, cin in (((6, 10, 18), 128), ((7, 11, 13), 3)):
        box = q1.tile_plan((1, *dhw, cin), 64)["box"]
        assert all(s % b for s, b in zip(dhw, box)), (dhw, box)


def _layer(n, dhw, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (n, *dhw, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (cout, cin, 3, 3, 3)).astype(np.int8)
    return x, w, q1.pack_weights(w)


def _box_rows(x, n, origin, box, c0, bk):
    """A TMA box load of x [N, D, H, W, C] at (n, origin, c0): [128, bk]
    int8 rows, w fastest, zeros at coordinates outside the tensor."""
    _, d, h, w, _ = x.shape
    out = np.zeros((*box, bk), np.int8)
    ds, hs, ws = (np.arange(o, o + b) for o, b in zip(origin, box))
    okd, okh, okw = ((a >= 0) & (a < s) for a, s in zip((ds, hs, ws),
                                                        (d, h, w)))
    out[np.ix_(okd, okh, okw)] = x[n][np.ix_(ds[okd], hs[okh], ws[okw])][
        ..., c0:c0 + bk]
    return out.reshape(-1, bk)


def emulate_wgmma_route(x, wq, plan):
    """The wgmma route's int32 sums, computed as the kernel tiles them."""
    n_, d, h, w, cin = x.shape
    cout, bn, bk, box = wq.shape[0], plan["bn"], plan["bk"], plan["box"]
    out = np.full((n_, d, h, w, cout), np.iinfo(np.int32).min, np.int64)
    origins = q1.box_origins((d, h, w), box)
    cpt = cin // bk
    for bid in range(n_ * len(origins) * (cout // bn)):
        nt, rest = bid % (cout // bn), bid // (cout // bn)
        n, (d0, h0, w0) = rest // len(origins), origins[rest % len(origins)]
        n0 = nt * bn
        acc = np.zeros((q1.BOX_ROWS, bn), np.int64)
        for s in range(27 * cin // bk):  # the producer's K steps
            tap, c0 = s // cpt, (s % cpt) * bk
            kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
            a = _box_rows(x, n, (d0 + kd - 1, h0 + kh - 1, w0 + kw - 1), box,
                          c0, bk)
            b = wq[n0:n0 + bn, tap * cin + c0:tap * cin + c0 + bk]
            acc += a.astype(np.int64) @ b.astype(np.int64).T
        for r in range(q1.BOX_ROWS):  # the epilogue's stores
            rd, rh, rw = r // (box[1] * box[2]), (r // box[2]) % box[1], \
                r % box[2]
            if d0 + rd < d and h0 + rh < h and w0 + rw < w:
                cell = out[n, d0 + rd, h0 + rh, w0 + rw, n0:n0 + bn]
                assert (cell == np.iinfo(np.int32).min).all(), "stored twice"
                cell[:] = acc[r]
    assert (out != np.iinfo(np.int32).min).all(), "a position never stored"
    return out


@pytest.mark.parametrize("n,dhw,cin,cout", [
    (1, (4, 4, 8), 64, 64),      # one exact box, BN = 64, BK = 64
    (2, (3, 5, 7), 64, 128),     # ragged everywhere, BK = 64, BN = 128
    (1, (6, 10, 18), 128, 256),  # the card's ragged case, BK = 128, BN = 256
    (2, (2, 7, 7), 128, 512),    # conv5's box past a 7x7 volume, 2 Cout tiles
    (1, (5, 9, 13), 192, 128),   # Cin 192: BK = 64, three chunks a tap
])
def test_wgmma_route_emulation_matches_plain_and_jax(n, dhw, cin, cout):
    x, w, wq = _layer(n, dhw, cin, cout, seed=cin + cout + dhw[0])
    plan = q1.tile_plan(x.shape, cout)
    assert plan["route"] == "wgmma"
    got = emulate_wgmma_route(x, wq, plan)
    want = q1.conv3d_int32_plain(torch.from_numpy(x), torch.from_numpy(wq))
    np.testing.assert_array_equal(got, want.numpy())
    jax_acc = jquant._conv3d_int8(
        jnp.asarray(x), jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0))))
    np.testing.assert_array_equal(got, np.asarray(jax_acc))


def emulate_halo_route(x, wq, plan):
    """The halo route's int32 sums: per box, the halo as 32-bit words (a
    position's channel bytes, zero-padded), each row's 32 tap words read
    at rbase(row) + toff(tap) (taps past 26 at tap 26's), times the packed
    [Cout, 128] weights."""
    n_, d, h, w, cin = x.shape
    bd, bh, bw = plan["box"]
    hh, hw = bh + 2, bw + 2
    out = np.zeros((n_, d, h, w, wq.shape[0]), np.int64)
    taps = np.minimum(np.arange(32), 26)
    toff = ((taps // 9) * hh + (taps // 3) % 3) * hw + taps % 3
    r = np.arange(q1.BOX_ROWS)
    rd, rh, rw = r // (bh * bw), (r // bw) % bh, r % bw
    rbase = (rd * hh + rh) * hw + rw
    xp = np.zeros((n_, d + bd + 2, h + bh + 2, w + bw + 2, 4), np.uint8)
    xp[:, 1:d + 1, 1:h + 1, 1:w + 1, :cin] = x.view(np.uint8)
    words = xp.view(np.uint32)[..., 0]  # little-endian: byte c = channel c
    for n in range(n_):
        for d0, h0, w0 in q1.box_origins((d, h, w), plan["box"]):
            halo = words[n, d0:d0 + bd + 2, h0:h0 + bh + 2,
                         w0:w0 + bw + 2].reshape(-1)
            assert halo.size == q1.halo_words(plan["box"])
            a = halo[rbase[:, None] + toff[None, :]]  # [128 rows, 32 taps]
            a = a.view(np.uint8).view(np.int8).reshape(q1.BOX_ROWS, 128)
            acc = a.astype(np.int64) @ wq.astype(np.int64).T
            keep = (d0 + rd < d) & (h0 + rh < h) & (w0 + rw < w)
            out[n, d0 + rd[keep], h0 + rh[keep], w0 + rw[keep]] = acc[keep]
    return out


@pytest.mark.parametrize("n,dhw,cin", [
    (1, (7, 11, 13), 3),    # the card's ragged case
    (2, (4, 8, 16), 3),     # whole boxes
    (1, (3, 5, 7), 1),      # Cin 1 and 4: the word's other bytes
    (1, (5, 6, 9), 4),
])
def test_halo_route_emulation_matches_plain(n, dhw, cin):
    x, _, wq = _layer(n, dhw, cin, 64, seed=cin + dhw[2])
    plan = q1.tile_plan(x.shape, 64)
    assert plan["route"] == "halo" and wq.shape == (64, 128)
    got = emulate_halo_route(x, wq, plan)
    want = q1.conv3d_int32_plain(torch.from_numpy(x), torch.from_numpy(wq))
    np.testing.assert_array_equal(got, want.numpy())


MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
MAGIC_BITS = 0x4B400000


def emulate_requant(y: np.ndarray, s: np.float32) -> np.ndarray:
    """The kernel's requant of y >= 0 (f32) at scale s: t = min(y * RN(1/s),
    127) rounded to an integer through the magic number, which the sum's
    low byte holds; that byte where t is at least 2e-4 from a
    half-integer, else round(RN(y / s)) clipped."""
    with np.errstate(over="ignore", invalid="ignore"):  # y = inf, 3e38
        r = np.float32(1.0) / s
        t = np.minimum(y * r, np.float32(127.0))
        m = t + MAGIC
        fast = np.abs(t - (m - MAGIC)) < np.float32(0.4998)
        low_byte = m.view(np.uint32) & 0xFF
        slow = np.clip(np.rint(y / s), -127, 127)
        return np.where(fast, low_byte, slow).astype(np.int8)


def test_small_sums_convert_exactly():
    """The halo route's int -> float of a sum |acc| < 2^22 through the
    magic number equals the rounding conversion."""
    acc = np.concatenate([np.arange(-4096, 4096), np.arange(
        -2 ** 22 + 1, 2 ** 22, 9973), [-2 ** 22 + 1, 2 ** 22 - 1]]).astype(
            np.int32)
    got = (acc + MAGIC_BITS).view(np.float32) - MAGIC
    np.testing.assert_array_equal(got, acc.astype(np.float32))
    # the halo route's largest sum: 27 taps x 4 channels of 127 * 127
    assert 27 * 4 * 127 * 127 < 2 ** 22


@pytest.mark.parametrize("scale", [3.7e-4, 0.0123, 0.05, 0.71, 2.5])
def test_requant_estimate_matches_the_division(scale):
    s = np.float32(scale)
    rng = np.random.RandomState(int(scale * 1e4))
    k = rng.randint(0, 200, 50000)
    ties = ((k + 0.5) * np.float64(s)).astype(np.float32)
    y = np.concatenate([
        ties, np.nextafter(ties, np.float32(np.inf)),
        np.nextafter(ties, np.float32(0)),
        (rng.rand(50000) * 200 * s).astype(np.float32),
        np.float32([0.0, 1e-30, 3e38, np.inf])]).astype(np.float32)
    want = q1.quantize(torch.from_numpy(y), float(s)).numpy()
    np.testing.assert_array_equal(emulate_requant(y, s), want)
