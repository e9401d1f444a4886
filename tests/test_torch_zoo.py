"""The rest of the model zoo (gaze_rnn, gaze_rnn77, gaze_c3d_conv,
gaze_framewise_shallownet, gaze_grcn_cascade, gaze_pupil_grcn,
gaze_pupil_gru2) against the JAX models on the CPU in f32, at each
family's published widths with B=2, T=3, the weights drawn with numpy
from a seed in the names and shapes of the JAX package's init (`pair`),
carried across by `bridge.py`, dropout off: the forwards here, the losses
and gradients in test_torch_zoo_grads.py.

Logits and predicted maps at rtol 1e-4 / atol 1e-5, the JAX package's
kernel-test tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models import gaze_grcn_cascade as jcascade
from recurrent_gaze_prediction_tpu.models import gaze_rnn as jrnn
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax

NEW_FAMILIES = ["gaze_rnn", "gaze_rnn77", "gaze_c3d_conv",
                "gaze_framewise_shallownet", "gaze_grcn_cascade",
                "gaze_pupil_grcn", "gaze_pupil_gru2"]
B, T = 2, 3


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    """Under pytest-xdist, torch gets this worker's share of the cores:
    every worker running torch's default of one thread per core slows the
    full-width tests ~2x (5 workers on 8 cores: 240 s against 117 s for
    this file and its four heaviest neighbours). Alone, nothing changes."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    saved = torch.get_num_threads()
    torch.set_num_threads(max(1, min(saved, (os.cpu_count() or 1)
                                     // workers)))
    yield
    torch.set_num_threads(saved)


def _draw(rng, shape) -> np.ndarray:
    """N(0, 1/fan_in) for a kernel (fan_in: all but its last axis), N(0,
    0.1^2) for a vector."""
    scale = 1 / np.sqrt(np.prod(shape[:-1])) if len(shape) > 1 else 0.1
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def pair(name, seed=0, t=T):
    """(JAX model, its params, the port's model with the same weights): the
    JAX init's names and shapes (`jax.eval_shape`) drawn with numpy from
    `seed`. (The reference init's 1e-4 ConvGRU kernels would leave the
    recurrence ~0, and drawing 84 M numbers with `jax.random` costs more
    than the tests.)"""
    kw = dict(n_lstm_steps=t, compute_dtype="float32", dropout_keep_prob=1.0)
    jmodel = jregistry.create_model(name, **kw)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: _draw(rng, s.shape),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed)))
    tmodel = registry.create_model(name, device="cpu", **kw)
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


def batch_for(cfg, seed=2):
    rng = np.random.RandomState(seed)
    gh, gw = cfg.gazemap_height, cfg.gazemap_width
    return {"frames": rng.rand(B, T, 98, 98, 3).astype(np.float32),
            "c3d": rng.randn(B, T, 1024, 7, 7).astype(np.float32),
            "gazemaps": np.abs(rng.randn(B, T, gh, gw)).astype(np.float32),
            "pupils": rng.randn(B, T).astype(np.float32)}


@pytest.fixture(scope="module", params=NEW_FAMILIES)
def family(request):
    """One family's pair, shared by the tests that take it (those that need
    only some families parametrize it indirectly): pytest runs them family
    by family, so one full-width pair is alive at a time."""
    return pair(request.param)


def test_logits_and_predict_match_jax(family):
    jmodel, params, tmodel = family
    batch = batch_for(jmodel.cfg)
    frames, c3d = jnp.asarray(batch["frames"]), jnp.asarray(batch["c3d"])
    j_logits = np.asarray(jmodel.apply(params, frames, c3d))
    j_maps = np.asarray(jmodel.predict(params, frames, c3d))
    tf, tc = torch.from_numpy(batch["frames"]), torch.from_numpy(batch["c3d"])
    with torch.no_grad():
        t_logits = tmodel(tf, tc).numpy()
    t_maps = tmodel.predict(tf, tc).numpy()
    gh, gw = jmodel.cfg.gazemap_height, jmodel.cfg.gazemap_width
    assert t_logits.shape == t_maps.shape == (B, T, gh, gw)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_maps, j_maps, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["gaze_pupil_gru2"], indirect=True)
def test_gru2_teacher_forcing_reads_the_previous_step_only(family):
    """Step t sees targets[t-1] through the tied inverse projection and step
    0 a zero embedding: changing the last step's targets changes no
    logit, changing step 0's changes steps 1.. and not step 0; inference
    feeds zeros."""
    _, _, tmodel = family
    rng = np.random.RandomState(3)
    c3d = torch.from_numpy(rng.randn(B, T, 1024, 7, 7).astype(np.float32))
    targets = torch.from_numpy(rng.rand(B, T, 50).astype(np.float32))
    with torch.no_grad():
        base = tmodel.joint(None, c3d, targets)
        last = targets.clone()
        last[:, -1] += 1.0
        first = targets.clone()
        first[:, 0] += 1.0
        assert torch.equal(tmodel.joint(None, c3d, last), base)
        moved = tmodel.joint(None, c3d, first)
        assert torch.equal(moved[:, 0], base[:, 0])
        assert not torch.allclose(moved[:, 1:], base[:, 1:])
        zeros = tmodel.joint(None, c3d, torch.zeros_like(targets))
        np.testing.assert_array_equal(
            tmodel(None, c3d).numpy(),
            zeros[..., :49].reshape(B, T, 7, 7).numpy())


@pytest.mark.parametrize("family", ["gaze_rnn", "gaze_rnn77",
                                    "gaze_grcn_cascade"], indirect=True)
def test_shallownet_branch_runs_only_for_the_net_dict(family):
    """The ShallowNet branch feeds nothing: the forward reads no frames
    (`reads_frames` False, frames may be None), and a caller's `net` dict
    gets the JAX package's frm_sal (and at 7x7 frm_sal_77)."""
    jmodel, params, tmodel = family
    name = tmodel.cfg.name
    assert tmodel.reads_frames is False and tmodel.has_shallownet is True
    batch = batch_for(jmodel.cfg)
    tc = torch.from_numpy(batch["c3d"])
    jnet, tnet = {}, {}
    japply = jcascade.apply if name == "gaze_grcn_cascade" else jrnn.apply
    japply(params, jnp.asarray(batch["frames"]), jnp.asarray(batch["c3d"]),
           jmodel.cfg, net=jnet)
    with torch.no_grad():
        plain = tmodel(None, tc)
        with_net = tmodel(torch.from_numpy(batch["frames"]), tc, net=tnet)
    assert torch.equal(plain, with_net)
    assert sorted(tnet) == sorted(jnet)
    for key in jnet:
        np.testing.assert_allclose(tnet[key].numpy(), np.asarray(jnet[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_c3d_conv_composed_decoder_without_bn_matches_jax():
    """At B*T = 32 frames gaze_c3d_conv's decoder runs composed into one
    matrix (`decoder_matrix` without the BN fold, which this decoder
    lacks); its logits against the JAX model's, and the stagewise form on
    the same frames."""
    from recurrent_gaze_prediction_tpu_torch.models import common

    jmodel, params, tmodel = pair("gaze_c3d_conv", t=16)
    assert "bn_scale" not in tmodel.decoder
    rng = np.random.RandomState(5)
    c3d = rng.randn(B, 16, 1024, 7, 7).astype(np.float32)
    want = np.asarray(jmodel.apply(params, None, jnp.asarray(c3d)))
    with torch.no_grad():
        got = tmodel(None, torch.from_numpy(c3d))
        x = torch.from_numpy(rng.randn(32, 7, 7, 512).astype(np.float32))
        kw = dict(keep_prob=1.0, generator=None, train=False,
                  compute_dtype=torch.float32)
        composed = common.apply_decoder_composed(tmodel.decoder, x, **kw)
        stagewise = common.apply_decoder_stagewise(tmodel.decoder, x, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(composed.numpy(), stagewise.numpy(),
                               rtol=1e-4, atol=1e-5)
