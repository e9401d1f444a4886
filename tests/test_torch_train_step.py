"""The port's train step against the JAX package's on the CPU, in f32, at
narrow widths with the 49x49 head, weights and optimizer state carried
across by `bridge.py`, flip and dropout off (the two packages draw
different random numbers).

Loss and grad_norm are held at rtol 1e-4; the params after each update at
rtol 1e-3 / atol 1e-5 (the JAX package's gradient tolerance), lr 1e-3.

Adam runs with the l2 loss: under xentropy the head bias's gradient is
zero up to rounding (softmax ignores a constant shift of the logits), and
Adam's first update divides that rounding noise by its own magnitude, so
the two packages' bias updates would be noise of size lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.config import OptimizerConfig as JOptCfg
from recurrent_gaze_prediction_tpu.train.state import TrainState as JState
from recurrent_gaze_prediction_tpu.train.state import (
    build_optimizer as j_build_optimizer)
from recurrent_gaze_prediction_tpu.train.state import (
    make_train_step as j_make_train_step)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (
    flatten_params, jax_name, opt_state_from_jax, params_from_jax)
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.train import (
    TrainState, create_train_state, make_eval_step, make_train_step)

T = 3
WIDTHS = dict(n_lstm_steps=T, dim_feature=16, dim_cnn_proj=8,
              rnn_state_size=8, compute_dtype="float32",
              dropout_keep_prob=1.0, use_flip_batch=False)


def _opt(method="adam", max_grad_norm=10.0):
    # decay_steps 1: the staircase schedule steps between the two updates
    return dict(method=method, initial_learning_rate=1e-3,
                learning_rate_decay=0.8, decay_steps=1,
                max_grad_norm=max_grad_norm)


LOSS = {"adam": "l2", "rmsprop": "xentropy", "sgd": "xentropy"}


def _pair(opt: dict, seed=0):
    """The JAX train state with random cell weights (x0.3) and a
    non-trivial frozen-BN affine, and the port's model and state with the
    same weights."""
    widths = dict(WIDTHS, loss_type=LOSS[opt["method"]])
    jmodel = jregistry.create_model("gaze_grcn", **widths)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    params["decoder"]["bn_scale"] = jnp.asarray(
        1 + 0.2 * rng.randn(8).astype(np.float32))
    params["decoder"]["bn_offset"] = jnp.asarray(
        0.2 * rng.randn(8).astype(np.float32))
    jtx = j_build_optimizer(JOptCfg(**opt), params)
    jstate = JState(params=params, opt_state=jtx.init(params),
                    step=jnp.zeros((), jnp.int32))
    tmodel = registry.create_model("gaze_grcn", device="cpu", **widths)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tstate, ttx = create_train_state(tmodel, OptimizerConfig(**opt))
    return jmodel, jtx, jstate, tmodel, ttx, tstate


def _batch(seed, b=2):
    rng = np.random.RandomState(100 + seed)
    return {"frames": np.zeros((b, T, 98, 98, 3), np.float32),
            "c3d": rng.randn(b, T, 16, 7, 7).astype(np.float32),
            "gazemaps": np.abs(rng.randn(b, T, 49, 49)).astype(np.float32)}


def _step_both(jstep, jstate, tstep, tstate, batch):
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    return jstate, jm, tstate, tm


def _assert_match(jm, jstate, tm, tstate):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert tm["step"] == int(jm["step"])
    jflat = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    assert set(jflat) == {jax_name(n) for n in tstate.params}
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[jax_name(name)],
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("method", ["adam", "rmsprop", "sgd"])
def test_two_train_steps_match_jax(method):
    jmodel, jtx, jstate, tmodel, ttx, tstate = _pair(_opt(method))
    jstep = j_make_train_step(jmodel, jtx, use_flip=False, donate=False)
    tstep = make_train_step(tmodel, ttx, use_flip=False)
    for k in range(2):
        jstate, jm, tstate, tm = _step_both(jstep, jstate, tstep, tstate,
                                            _batch(k))
        _assert_match(jm, jstate, tm, tstate)


def test_clipped_train_step_matches_jax():
    """max_grad_norm far below the gradient's norm: the clip triggers (SGD,
    whose update scales with the clipped gradient)."""
    jmodel, jtx, jstate, tmodel, ttx, tstate = _pair(
        _opt("sgd", max_grad_norm=1e-4))
    jstep = j_make_train_step(jmodel, jtx, use_flip=False, donate=False)
    tstep = make_train_step(tmodel, ttx, use_flip=False)
    jstate, jm, tstate, tm = _step_both(jstep, jstate, tstep, tstate,
                                        _batch(0))
    assert float(tm["grad_norm"]) > 10 * 1e-4
    _assert_match(jm, jstate, tm, tstate)


@pytest.mark.parametrize("method", ["adam", "rmsprop", "sgd"])
def test_resume_from_jax_state_after_one_step(method):
    """Both packages start from the same state at step 1 (params, optax
    moments and count through `opt_state_from_jax`) and take one more
    step."""
    jmodel, jtx, jstate, tmodel, ttx, _ = _pair(_opt(method), seed=1)
    jstep = j_make_train_step(jmodel, jtx, use_flip=False, donate=False)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                               for k, v in _batch(0).items()},
                      jax.random.PRNGKey(0))
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    opt_state = opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state))
    assert opt_state["count"] == 1
    tstate = TrainState(params=dict(tmodel.named_parameters()),
                        opt_state=opt_state, step=int(jstate.step))
    tstep = make_train_step(tmodel, ttx, use_flip=False)
    jstate, jm, tstate, tm = _step_both(jstep, jstate, tstep, tstate,
                                        _batch(1))
    _assert_match(jm, jstate, tm, tstate)


def test_accumulated_step_equals_full_batch_step():
    """accum_steps=2 on a batch of 4 takes the same update as one pass
    over it (the loss is a mean over B*T, so the mean of the two
    microbatch means is the full mean)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(0, b=4).items()}
    results = []
    for accum in (1, 2):
        _, _, _, tmodel, ttx, tstate = _pair(_opt("sgd"))
        step = make_train_step(tmodel, ttx, use_flip=False,
                               accum_steps=accum)
        tstate, metrics = step(tstate, batch)
        results.append((metrics, {n: p.detach().clone()
                                  for n, p in tstate.params.items()}))
    (m1, p1), (m2, p2) = results
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for name in p1:
        np.testing.assert_allclose(p2[name].numpy(), p1[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    _, _, _, tmodel, ttx, tstate = _pair(_opt("sgd"))
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(tmodel, ttx, use_flip=False, accum_steps=3)(
            tstate, batch)


def test_eval_step_matches_jax_loss():
    jmodel, _, jstate, tmodel, _, _ = _pair(_opt())
    batch = _batch(2)
    jloss, _ = jmodel.loss(jstate.params, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                           train=False)
    tloss = make_eval_step(tmodel)({k: torch.from_numpy(v)
                                    for k, v in batch.items()})["loss"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
