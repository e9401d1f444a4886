"""The port's batched saliency metrics (`eval/metrics_torch.py`) against the
JAX package's (`eval/metrics_jax.py`) on the CPU, on the same inputs made
from a seed with numpy, and the port's copy of `metrics_np.py` against the
JAX package's.

Tolerances: rtol 1e-5 / atol 1e-6 for cc, sim, nss and kld, atol 1e-5 for
the AUCs (f32, the two packages reduce in different orders). The two
packages' random streams differ, so AUC_shuffled gets the same explicit
other map on both sides, and AUC_Judd's 1e-7 tie-breaking jitter is made
moot by predictions whose values lie far apart (a rank map), except on the
constant frame, whose AUC_Judd is the jitter's coin toss and is not
compared. bf16 predictions are range-normalized in bf16 by both packages
before the f32 metrics; they are held to the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu.eval import metrics_jax as mj
from recurrent_gaze_prediction_tpu.eval import metrics_np as jmnp
from recurrent_gaze_prediction_tpu_torch.eval import metrics_np as tmnp
from recurrent_gaze_prediction_tpu_torch.eval import metrics_torch as mt

DIST_TOL = dict(rtol=1e-5, atol=1e-6)
AUC_TOL = dict(rtol=0, atol=1e-5)
TOL = {"cc": DIST_TOL, "sim": DIST_TOL, "nss": DIST_TOL, "kld": DIST_TOL,
       "AUC_Judd": AUC_TOL, "AUC_Borji": AUC_TOL, "AUC_shuffled": AUC_TOL}


def _frames(n=12, h=21, w=21, seed=0, n_fix_range=(3, 12)):
    """Random gt maps, sparse fixations and predictions (noisy gt as a
    rank map: all values distinct, 1/(h*w) apart); frame 0 has no
    fixation and frame 1 a constant prediction (the NaN cases)."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(n, h, w).astype(np.float32) + 0.05
    noisy = (gt + 0.5 * rng.rand(n, h, w)).reshape(n, -1)
    pred = (np.argsort(np.argsort(noisy, -1), -1).reshape(n, h, w)
            / (h * w)).astype(np.float32)
    fix = np.zeros((n, h, w), np.float32)
    for i in range(1, n):
        k = rng.randint(*n_fix_range)
        fix[i, rng.randint(0, h, k), rng.randint(0, w, k)] = 1.0
    pred[1] = 0.25
    return pred, gt, fix


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(ours, theirs, tol):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_allclose(ours, theirs, **tol)


@pytest.mark.parametrize("name", ["cc", "sim", "kld"])
def test_map_metrics_match_jax(name):
    pred, gt, _ = _frames(seed=1)
    ours = getattr(mt, f"{name}_batch")(_t(pred), _t(gt))
    theirs = getattr(mj, f"{name}_batch")(jnp.asarray(pred), jnp.asarray(gt))
    _close(ours, theirs, TOL[name])


def test_nss_matches_jax_with_population_std():
    pred, _, fix = _frames(seed=2)
    ours = mt.nss_batch(_t(pred), _t(fix))
    _close(ours, mj.nss_batch(jnp.asarray(pred), jnp.asarray(fix)),
           TOL["nss"])
    assert torch.isnan(ours[0]) and not torch.isnan(ours[2])


@pytest.mark.parametrize("jitter", [False, True])
def test_auc_judd_matches_jax(jitter):
    pred, _, fix = _frames(seed=3)
    ours = mt.auc_judd_batch(_t(pred), _t(fix), jitter=jitter)
    theirs = mj.auc_judd_batch(jnp.asarray(pred), jnp.asarray(fix),
                               jax.random.PRNGKey(0), jitter=jitter)
    keep = [0] + list(range(2, 12))  # frame 1 is constant: ties
    _close(ours[keep], np.asarray(theirs)[keep], TOL["AUC_Judd"])
    assert torch.isnan(ours[0])


def test_exact_borji_and_shuffled_match_jax():
    pred, _, fix = _frames(seed=4)
    other = (fix[2:9] > 0).sum(0)
    _close(mt.auc_borji_batch(_t(pred), _t(fix)),
           mj.auc_borji_batch(jnp.asarray(pred), jnp.asarray(fix),
                              jax.random.PRNGKey(0)), TOL["AUC_Borji"])
    _close(mt.auc_shuffled_batch(_t(pred), _t(fix), _t(other)),
           mj.auc_shuffled_batch(jnp.asarray(pred), jnp.asarray(fix),
                                 jnp.asarray(other), jax.random.PRNGKey(0)),
           TOL["AUC_shuffled"])


def _check_evaluate_batch(pred, gt, fix, other, n, **kw):
    ours = mt.evaluate_batch(_t(pred), _t(gt), _t(fix),
                             metrics=mt.ALL_METRICS, other_map=_t(other),
                             **kw)
    theirs = mj.evaluate_batch(jnp.asarray(pred), jnp.asarray(gt),
                               jnp.asarray(fix), jax.random.PRNGKey(0),
                               metrics=mj.ALL_METRICS,
                               other_map=jnp.asarray(other), **kw)
    assert set(ours) == set(mt.ALL_METRICS)
    for m in mt.ALL_METRICS:
        assert ours[m].shape == (n,) and ours[m].dtype == torch.float32
        keep = [i for i in range(n) if m != "AUC_Judd" or i != 1]
        _close(ours[m][keep], np.asarray(theirs[m])[keep], TOL[m])
    return ours


@pytest.mark.parametrize("chunk_size", [None, 5])
def test_evaluate_batch_matches_jax(chunk_size):
    """All seven metrics, exact, with a given other map; chunk 5 of 12
    frames pads the last chunk, whose padding must not leak."""
    pred, gt, fix = _frames(seed=5)
    ours = _check_evaluate_batch(pred, gt, fix, (fix[3:11] > 0).sum(0), 12,
                                 chunk_size=chunk_size)
    assert torch.isnan(ours["cc"][1]) and torch.isnan(ours["sim"][1])
    for m in ("nss", "AUC_Judd", "AUC_Borji", "AUC_shuffled"):
        assert torch.isnan(ours[m][0]), m


def test_evaluate_batch_bf16_predictions_match_jax():
    """bf16 predictions: range-normalized in bf16, then scored in f32, as
    the JAX package's source states. Held against that source run op by op
    (`jax.disable_jit`): XLA's compiled program folds away the bf16
    rounding of the normalized map, which moves its scores by up to ~2e-3
    (nss) on these maps, so the jitted values are held only to that. At
    9x9 the rank map's values stay distinct in bf16."""
    pred, gt, fix = _frames(n=6, h=9, w=9, seed=6, n_fix_range=(2, 6))
    pred_bf16 = _t(pred).to(torch.bfloat16)
    assert pred_bf16[2].flatten().unique().numel() == 81
    other = (fix[2:] > 0).sum(0)
    ours = mt.evaluate_batch(pred_bf16, _t(gt), _t(fix),
                             metrics=mt.ALL_METRICS, other_map=_t(other))
    args = (jnp.asarray(pred, jnp.bfloat16), jnp.asarray(gt),
            jnp.asarray(fix), jax.random.PRNGKey(0))
    kw = dict(metrics=mj.ALL_METRICS, other_map=jnp.asarray(other))
    with jax.disable_jit():
        op_by_op = mj.evaluate_batch(*args, **kw)
    jitted = mj.evaluate_batch(*args, **kw)
    for m in mt.ALL_METRICS:
        keep = [i for i in range(6) if m != "AUC_Judd" or i != 1]
        _close(ours[m][keep], np.asarray(op_by_op[m])[keep], TOL[m])
        _close(ours[m][keep], np.asarray(jitted[m])[keep],
               dict(rtol=0, atol=5e-3))


def test_capacity_autosizing_past_64_fixations():
    """A frame with more than 64 fixated pixels raises AUC_Judd's threshold
    capacity: the score matches the JAX package's and the numpy golden,
    where a fixed capacity of 64 does not."""
    pred, gt, _ = _frames(n=4, h=49, w=49, seed=12)
    fix = (np.random.RandomState(13).rand(4, 49, 49) < 0.06).astype(
        np.float32)
    assert fix.reshape(4, -1).sum(-1).max() > 64
    ours = mt.evaluate_batch(_t(pred), _t(gt), _t(fix),
                             metrics=("AUC_Judd",))["AUC_Judd"]
    theirs = mj.evaluate_batch(jnp.asarray(pred), jnp.asarray(gt),
                               jnp.asarray(fix), jax.random.PRNGKey(0),
                               metrics=("AUC_Judd",))["AUC_Judd"]
    keep = [0, 2, 3]  # frame 1 is constant: ties
    _close(ours[keep], np.asarray(theirs)[keep], TOL["AUC_Judd"])
    ref = [tmnp.AUC_Judd(fix[i], pred[i], jitter=False) for i in keep]
    np.testing.assert_allclose(ours[keep].numpy(), ref, atol=1e-5)
    capped = mt.auc_judd_batch(_t(pred), _t(fix), jitter=False)
    assert not np.allclose(capped[keep].numpy(), ref, atol=1e-3)


def test_sampled_aucs_are_within_noise_of_exact():
    """exact=True is the samplers' expectation: the mean of four seeded
    sampled runs lands within 0.02 (Borji) / 0.03 (shuffled) of it, as
    the JAX package's test_auc_exact_is_sampler_expectation holds."""
    pred, _, fix = _frames(n=10, seed=11, n_fix_range=(8, 16))
    pred, fix = _t(pred), _t(fix)
    other = (fix[:8] > 0).sum(0)
    gens = [torch.Generator().manual_seed(k) for k in range(4)]
    exact_b = mt.auc_borji_batch(pred, fix)
    sampled_b = torch.stack([mt.auc_borji_batch(pred, fix, g, n_rep=128,
                                                exact=False)
                             for g in gens]).mean(0)
    np.testing.assert_allclose(exact_b[1:], sampled_b[1:], atol=0.02)
    exact_s = mt.auc_shuffled_batch(pred, fix, other)
    sampled_s = torch.stack([mt.auc_shuffled_batch(
        pred, fix, other, g, n_rep=128, exact=False)
        for g in gens]).mean(0)
    np.testing.assert_allclose(exact_s[1:], sampled_s[1:], atol=0.03)
    # through evaluate_batch: the sampled capacities are autosized
    scores = mt.evaluate_batch(pred, _t(np.ones((10, 21, 21), np.float32)),
                               fix, torch.Generator().manual_seed(0),
                               metrics=("AUC_Borji", "AUC_shuffled"),
                               other_map=other, n_rep=64, exact=False)
    for m in scores:
        assert scores[m].shape == (10,) and torch.isnan(scores[m][0])
        assert bool(((scores[m][1:] >= 0) & (scores[m][1:] <= 1)).all())


def test_other_map_union_is_a_seeded_union_of_m_maps():
    _, _, fix = _frames(n=12, seed=7)
    fix_t = _t(fix)
    a = mt.build_other_map_union(fix_t, torch.Generator().manual_seed(1))
    b = mt.build_other_map_union(fix_t, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (21, 21)
    # a sum of 10 distinct frames' masks: 10 <= sum over frames, and every
    # count is at most 10
    assert int(a.max()) <= 10
    every = mt.build_other_map_union(fix_t, m=12)
    assert torch.equal(every, (fix_t > 0).sum(0))


def test_metrics_np_copy_equals_jax_under_the_same_random_state():
    pred, gt, fix = _frames(n=6, seed=8, n_fix_range=(4, 9))
    fix_big = np.zeros((6, 40, 50), np.float32)
    rng = np.random.RandomState(9)
    for i in range(6):
        fix_big[i, rng.randint(0, 40, 5), rng.randint(0, 50, 5)] = 1.0
    for metric in tmnp.ALL_METRICS:
        for fixations in (fix, fix_big):
            ours = tmnp.saliency_scores(metric, pred, gt, fixations,
                                        rng=np.random.RandomState(3))
            theirs = jmnp.saliency_scores(metric, pred, gt, fixations,
                                          rng=np.random.RandomState(3))
            np.testing.assert_array_equal(ours, theirs)
