"""The model zoo's losses and gradients against the JAX package on the CPU
in f32 (the pairs and batches of test_torch_zoo.py: published widths, B=2,
T=3, dropout off): every family's loss at rtol 1e-4 (the pupil
prototypes' joint losses included) and every parameter gradient at rtol
1e-3 / atol 1e-5, the JAX package's gradient tolerance; the pupil losses'
divisor; the cascade's remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu_torch.bridge import flatten_params, jax_name
from test_torch_zoo import (B, NEW_FAMILIES, T, batch_for, pair,
                            torch_threads_per_worker)  # noqa: F401


@pytest.fixture(scope="module", params=NEW_FAMILIES)
def family(request):
    """One family's pair, shared by the tests that take it (those that need
    only some families parametrize it indirectly)."""
    return pair(request.param)


def test_loss_and_grads_match_jax(family):
    """`loss` (the pupil prototypes' joint losses, the others'
    `sequence_loss`) and every parameter gradient against
    `jax.value_and_grad` of the JAX loss; train=True with dropout off (the
    cascade's cells rematerialized, gaze_pupil_grcn through the kernels'
    trainable Function, whose wrappers run the plain versions here)."""
    jmodel, params, tmodel = family
    batch = batch_for(jmodel.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, train=True)[0])(params)
    t_loss, _ = tmodel.loss({k: torch.from_numpy(v)
                             for k, v in batch.items()}, train=True)
    names, tensors = zip(*tmodel.named_parameters())
    t_grads = torch.autograd.grad(t_loss, tensors, allow_unused=True)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-4)
    j_flat = flatten_params(jax.tree_util.tree_map(np.asarray, j_grads))
    assert sorted(map(jax_name, names)) == sorted(j_flat)
    for n, g, p in zip(names, t_grads, tensors):
        got = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(got.numpy(), j_flat[jax_name(n)],
                                   rtol=1e-3, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("family", ["gaze_pupil_grcn", "gaze_pupil_gru2"],
                         indirect=True)
def test_pupil_losses_divide_by_batch_only(family):
    """The joint loss is (gaze + w * pupil) / B, not / (B*T): the gaze part
    l2 on the raw maps (grcn) or softmax xent on normalized maps (gru2),
    the pupil part 0.5 * sum of squares, with w 0.01 (grcn) or 0.5
    (gru2)."""
    _, _, tmodel = family
    name = tmodel.cfg.name
    batch = {k: torch.from_numpy(v) for k, v in batch_for(tmodel.cfg).items()}
    with torch.no_grad():
        loss, aux = tmodel.loss(batch, train=False)
        joint = tmodel.joint(None, batch["c3d"], None)
    pupil = 0.5 * (aux["pupil"] - batch["pupils"]).square().sum() / B
    weight = {"gaze_pupil_grcn": 0.01, "gaze_pupil_gru2": 0.5}[name]
    assert tmodel.pupil_weight == weight
    np.testing.assert_allclose(float(aux["pupil_loss"]), float(pupil),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(loss), float(aux["gaze_loss"] + weight * aux["pupil_loss"]),
        rtol=1e-6)
    if name == "gaze_pupil_grcn":
        gaze = 0.5 * (joint[..., :49] - batch["gazemaps"].reshape(B, T, 49)
                      ).square().sum() / B
        np.testing.assert_allclose(float(aux["gaze_loss"]), float(gaze),
                                   rtol=1e-6)


@pytest.mark.parametrize("family", ["gaze_grcn_cascade"], indirect=True)
def test_cascade_remat_changes_no_number(family):
    """The cascade's cells with remat (each step checkpointed) and without:
    the same loss and the same gradients."""
    _, _, tmodel = family
    batch = {k: torch.from_numpy(v) for k, v in batch_for(tmodel.cfg).items()}
    params = [p for _, p in tmodel.named_parameters()]
    out = {}
    try:
        for remat in (True, False):
            tmodel.cfg.remat_cells = remat
            loss, _ = tmodel.loss(batch, train=True)
            out[remat] = (loss.detach(), torch.autograd.grad(
                loss, params, allow_unused=True))
    finally:
        tmodel.cfg.remat_cells = True  # the pair is shared
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)
