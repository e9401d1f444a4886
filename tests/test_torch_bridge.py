"""Weights across the two packages: `bridge.params_from_jax` and
`params_to_jax`, and bundles written by one package read by the other."""

import jax
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.serving import export as jexport
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import (
    flatten_params, params_from_jax, params_to_jax, unflatten_params)
from recurrent_gaze_prediction_tpu_torch.serving import (
    load_bundle, save_bundle)
from test_torch_zoo import torch_threads_per_worker  # noqa: F401

WIDTHS = dict(dim_feature=16, dim_cnn_proj=8, rnn_state_size=8,
              n_lstm_steps=3, compute_dtype="float32")


def _jax_params(name):
    """The JAX model's params tree: its init's names and shapes (from
    `jax.eval_shape`, so the full-width zoo does not draw 84 M random
    numbers), filled with distinct position-dependent values."""
    shapes = jax.eval_shape(jregistry.create_model(name, **WIDTHS).init,
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (np.arange(int(np.prod(s.shape)), dtype=np.float32) % 251
                   ).reshape(s.shape), shapes)


@pytest.mark.parametrize("name", jregistry.available_models())
def test_param_names_and_shapes_match_jax(name):
    """The port's state dict is the JAX tree under the same names and
    shapes (the nested `shallownet.*`, `bottom_cell.*`, `top_cell.*` and
    FlatGRU's `cell.gates_kernel` included), and both directions invert
    each other, for every family."""
    jparams = _jax_params(name)
    model = registry.create_model(name, device="cpu", **WIDTHS)
    ported = params_to_jax(model)
    assert ({k: v.shape for k, v in jexport.flatten_params(jparams).items()}
            == {k: v.shape for k, v in flatten_params(ported).items()})
    model.load_state_dict(params_from_jax(jparams))
    back = flatten_params(params_to_jax(model))
    for k, v in jexport.flatten_params(jparams).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_params_from_jax_takes_nested_or_flat():
    jparams = _jax_params("gaze_grcn")
    nested = params_from_jax(jparams)
    flat = params_from_jax(jexport.flatten_params(jparams))
    assert nested.keys() == flat.keys()
    assert all(torch.equal(nested[k], flat[k]) for k in nested)
    assert "cell.W_z" in nested and "decoder.bn_offset" in nested
    assert unflatten_params(flatten_params(jparams)).keys() == jparams.keys()


def test_port_bundle_loads_in_both_readers(tmp_path):
    """A bundle the port writes: the JAX package's reader gets its config
    and weights, the port's reader its live model."""
    model = registry.create_model("gaze_grcn", device="cpu",
                                  generator=torch.Generator().manual_seed(3),
                                  **WIDTHS)
    save_bundle(str(tmp_path), model, wire_dtype="bfloat16")
    jbundle = jexport.load_bundle(str(tmp_path))
    assert jbundle.model_config.rnn_state_size == 8
    assert jbundle.programs == []
    want = flatten_params(params_to_jax(model))
    got = jexport.flatten_params(jbundle.params)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    again = load_bundle(str(tmp_path), device="cpu")
    assert again.cfg == model.cfg
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                again.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
