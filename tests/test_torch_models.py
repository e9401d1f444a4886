"""The port's gaze_grcn / gaze_grcn77 / gaze_lstm against the JAX models on
the CPU in f32 at narrow widths, weights carried across by `bridge.py`,
dropout off.

Logits and predicted maps are held at rtol 1e-4 / atol 1e-5, the JAX
package's kernel tolerance (maps, which are ~1/2401, at atol 1e-8).
gaze_lstm's loss is held at rtol 1e-4 and its parameter gradients at rtol
1e-3 / atol 1e-5, the JAX package's gradient tolerance, under the l2 loss:
under xentropy the head bias's gradient is zero up to rounding (softmax
ignores a constant shift of the logits), so it would be noise against
noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models.common import (
    sequence_loss as j_sequence_loss)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (
    flatten_params, jax_name, params_from_jax)
from recurrent_gaze_prediction_tpu_torch.models import common
from recurrent_gaze_prediction_tpu_torch.models.common import sequence_loss

WIDTHS = dict(dim_feature=16, dim_cnn_proj=8, rnn_state_size=8,
              compute_dtype="float32")


def _pair(name, t, seed=0, **overrides):
    """The JAX model with random params (the recurrence at a scale where
    it matters: the reference init 1e-4 keeps h ~ 0) and the port's model
    with the same weights."""
    widths = dict(WIDTHS, **overrides)
    jmodel = jregistry.create_model(name, n_lstm_steps=t, **widths)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    if "decoder" in params:  # non-trivial frozen-BN affine
        params["decoder"]["bn_scale"] = jnp.asarray(
            1 + 0.2 * rng.randn(8).astype(np.float32))
        params["decoder"]["bn_offset"] = jnp.asarray(
            0.2 * rng.randn(8).astype(np.float32))
    tmodel = registry.create_model(name, n_lstm_steps=t, device="cpu",
                                   **widths)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("name,b,t", [
    ("gaze_grcn", 2, 3),     # B*T = 6 < 32: stagewise decoder
    ("gaze_grcn", 2, 16),    # B*T = 32: composed decoder
    ("gaze_grcn77", 2, 5),
    ("gaze_lstm", 2, 3),
    ("gaze_lstm", 2, 16),
])
def test_logits_and_predict_match_jax(name, b, t):
    jmodel, params, tmodel = _pair(name, t)
    c3d = np.random.RandomState(1).randn(b, t, 16, 7, 7).astype(np.float32)
    frames = np.zeros((b, t, 98, 98, 3), np.float32)
    j_logits = jmodel.apply(params, jnp.asarray(frames), jnp.asarray(c3d))
    j_maps = jmodel.predict(params, jnp.asarray(frames), jnp.asarray(c3d))
    with torch.no_grad():
        t_logits = tmodel(torch.from_numpy(frames), torch.from_numpy(c3d))
    t_maps = tmodel.predict(torch.from_numpy(frames), torch.from_numpy(c3d))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_maps.numpy(), np.asarray(j_maps),
                               rtol=1e-4, atol=1e-8 if name != "gaze_grcn77"
                               else 1e-5)


@pytest.mark.parametrize("name", ["gaze_grcn", "gaze_lstm"])
def test_train_forward_without_dropout_equals_inference(name):
    """train=True runs the trainable recurrence (gaze_lstm: `ConvLSTM.scan`
    under autograd); with keep_prob 1 it computes what inference computes
    through the forward kernel's wrapper."""
    _, _, tmodel = _pair(name, 4)
    tmodel.cfg.dropout_keep_prob = 1.0
    c3d = torch.from_numpy(
        np.random.RandomState(2).randn(2, 4, 16, 7, 7).astype(np.float32))
    with torch.no_grad():
        a = tmodel(None, c3d, train=True)
        b = tmodel(None, c3d, train=False)
    assert torch.equal(a, b)


def test_decoder_stagewise_equals_composed():
    _, _, tmodel = _pair("gaze_grcn", 4)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(5, 7, 7, 8).astype(np.float32))
    kw = dict(keep_prob=1.0, generator=None, train=False,
              compute_dtype=torch.float32)
    with torch.no_grad():
        a = common.apply_decoder_stagewise(tmodel.decoder, x, **kw)
        b = common.apply_decoder_composed(tmodel.decoder, x, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loss_type", ["xentropy", "l2", "kld"])
@pytest.mark.parametrize("masked", [False, True])
def test_sequence_loss_matches_jax(loss_type, masked):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 4, 7, 9).astype(np.float32)
    gt = np.abs(rng.randn(3, 4, 7, 9)).astype(np.float32)
    gt /= gt.sum(axis=(-2, -1), keepdims=True)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    j = j_sequence_loss(jnp.asarray(logits), jnp.asarray(gt), loss_type,
                        frame_mask=jnp.asarray(mask) if masked else None)
    t = sequence_loss(torch.from_numpy(logits), torch.from_numpy(gt),
                      loss_type,
                      frame_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_model_loss_matches_jax():
    """`GazeModel.loss` (normalize the gt maps, then sequence_loss) on the
    same weights and batch, dropout off."""
    jmodel, params, tmodel = _pair("gaze_grcn", 3)
    tmodel.cfg.dropout_keep_prob = 1.0
    rng = np.random.RandomState(5)
    batch = {"frames": np.zeros((2, 3, 98, 98, 3), np.float32),
             "c3d": rng.randn(2, 3, 16, 7, 7).astype(np.float32),
             "gazemaps": np.abs(rng.randn(2, 3, 49, 49)).astype(np.float32),
             "frame_mask": np.array([[1, 1, 0], [1, 1, 1]], np.float32)}
    j, _ = jmodel.loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       train=False)
    t, _ = tmodel.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                       train=True)
    np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-4)


def test_gaze_lstm_loss_and_grads_match_jax():
    """gaze_lstm trains on `ConvLSTM.scan` under autograd, as the JAX
    package does: loss and every parameter gradient against
    `jax.value_and_grad` of the JAX loss."""
    jmodel, params, tmodel = _pair("gaze_lstm", 3, loss_type="l2",
                                   dropout_keep_prob=1.0)
    rng = np.random.RandomState(5)
    batch = {"frames": np.zeros((2, 3, 98, 98, 3), np.float32),
             "c3d": rng.randn(2, 3, 16, 7, 7).astype(np.float32),
             "gazemaps": np.abs(rng.randn(2, 3, 49, 49)).astype(np.float32),
             "frame_mask": np.array([[1, 1, 0], [1, 1, 1]], np.float32)}
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()},
                              train=True)[0])(params)
    t_loss, _ = tmodel.loss({k: torch.from_numpy(v)
                             for k, v in batch.items()}, train=True)
    names, tensors = zip(*tmodel.named_parameters())
    t_grads = torch.autograd.grad(t_loss, tensors)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-4)
    j_flat = flatten_params(jax.tree_util.tree_map(np.asarray, j_grads))
    assert sorted(map(jax_name, names)) == sorted(j_flat)
    for name, g in zip(names, t_grads):
        np.testing.assert_allclose(g.numpy(), j_flat[jax_name(name)],
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_unported_family_raises():
    """Every family of the JAX registry is ported; an unknown name raises
    KeyError, as in the JAX registry."""
    with pytest.raises(KeyError, match="Unknown model 'gaze_deeprnn'"):
        registry.create_model("gaze_deeprnn", device="cpu")
    with pytest.raises(KeyError, match="Unknown model"):
        registry.model_defaults("gaze_shallownet_rnn")


def test_registry_lists_the_jax_families_with_their_defaults():
    assert registry.available_models() == jregistry.available_models()
    assert len(registry.available_models()) == 10
    for name in jregistry.available_models():
        assert registry.model_defaults(name) == \
            jregistry.model_defaults(name), name


def test_registry_precedence_matches_jax():
    """Explicit kwargs > cfg fields set after construction > cfg fields
    off the dataclass default > per-model defaults, as in the JAX
    registry."""
    from recurrent_gaze_prediction_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    cfg.n_lstm_steps = 42          # set on purpose to the dataclass default
    cfg.rnn_state_size = 16        # off the default
    m = registry.create_model("gaze_grcn77", cfg, device="cpu",
                              dim_feature=16, dim_cnn_proj=8,
                              compute_dtype="float32")
    assert (m.cfg.n_lstm_steps, m.cfg.rnn_state_size) == (42, 16)
    assert (m.cfg.gazemap_height, m.cfg.gazemap_width) == (7, 7)
    assert m.cfg.name == "gaze_grcn77" and m.out_W.shape == (16, 1)
