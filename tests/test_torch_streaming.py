"""The port's carried-state streaming steps (`models/streaming.py`) and the
bundle's `stream` program against the JAX package's, on the CPU in f32 at
narrow widths, weights carried across by `bridge.py`.

Logits are held at rtol 1e-4 / atol 1e-5 and the carried state at the
same tolerance, the JAX package's kernel tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.models import streaming as jstreaming
from recurrent_gaze_prediction_tpu.serving import export as jexport
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.models import streaming
from recurrent_gaze_prediction_tpu_torch.serving import (
    initial_stream_state, load_bundle, save_bundle, stream_step)

WIDTHS = dict(dim_feature=16, dim_cnn_proj=8, rnn_state_size=8,
              compute_dtype="float32", batch_size=1)
MODELS = ["gaze_grcn", "gaze_lstm"]


def _pair(name, t=4, seed=0):
    """The JAX model with random params (cell weights x0.3 so the
    recurrence matters) and the port's model with the same weights."""
    jmodel = jregistry.create_model(name, n_lstm_steps=t, **WIDTHS)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    tmodel = registry.create_model(name, n_lstm_steps=t, device="cpu",
                                   **WIDTHS)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _feats(t, seed):
    return np.random.RandomState(seed).rand(t, 16, 7, 7).astype(np.float32)


def _stream(tmodel, feats, chunk_len, restart=False):
    """Chunks of `chunk_len` (the tail zero-padded, its logits trimmed)
    through the model's step, the state carried unless `restart`."""
    if tmodel.cfg.name == "gaze_grcn" and not restart:
        return list(streaming.stream_video(tmodel, feats,
                                           chunk_len=chunk_len))
    lstm = tmodel.cfg.name == "gaze_lstm"
    init = (streaming.init_lstm_stream_state if lstm
            else streaming.init_stream_state)
    step = streaming.lstm_stream_step if lstm else streaming.grcn_stream_step
    state = init(1, tmodel.cfg, device="cpu")
    out = []
    for start in range(0, len(feats), chunk_len):
        chunk = feats[start:start + chunk_len]
        valid = len(chunk)
        chunk = np.concatenate([chunk, np.zeros(
            (chunk_len - valid,) + chunk.shape[1:], np.float32)])
        new_state, maps = step(tmodel, state, torch.from_numpy(chunk[None]))
        state = init(1, tmodel.cfg, device="cpu") if restart else new_state
        out.append(maps[0, :valid].numpy())
    return out


@pytest.mark.parametrize("name", MODELS)
def test_streamed_equals_single_pass(name):
    """Chunks of 4 over 10 frames (the tail padded and trimmed) with the
    state carried == one pass over all 10."""
    _, _, tmodel = _pair(name)
    feats = _feats(10, seed=1)
    with torch.no_grad():
        full = tmodel(None, torch.from_numpy(feats[None]))[0].numpy()
    streamed = np.concatenate(_stream(tmodel, feats, 4))
    assert streamed.shape == full.shape == (10, 49, 49)
    np.testing.assert_allclose(streamed, full, rtol=1e-4, atol=1e-5)


def test_stream_video_trims_the_tail_chunk():
    _, _, tmodel = _pair("gaze_grcn")
    chunks = list(streaming.stream_video(tmodel, _feats(10, seed=2),
                                         chunk_len=4))
    assert [c.shape for c in chunks] == [(4, 49, 49), (4, 49, 49),
                                         (2, 49, 49)]


@pytest.mark.parametrize("name", MODELS)
def test_context_carries_across_chunks(name):
    """A zero-state restart per chunk (the reference's behaviour) equals
    the carried run on the first chunk and differs from it on the
    second: context flows."""
    _, _, tmodel = _pair(name)
    feats = _feats(8, seed=3)
    carried = np.concatenate(_stream(tmodel, feats, 4))
    restarted = np.concatenate(_stream(tmodel, feats, 4, restart=True))
    np.testing.assert_allclose(carried[:4], restarted[:4], rtol=1e-4,
                               atol=1e-5)
    assert not np.allclose(carried[4:], restarted[4:])


@pytest.mark.parametrize("name", MODELS)
def test_step_matches_jax_step(name):
    """One step from the same nonzero state on the same chunk: the new
    state and the logits equal JAX's `grcn_stream_step` /
    `lstm_stream_step`."""
    jmodel, params, tmodel = _pair(name)
    rng = np.random.RandomState(4)
    chunk = rng.randn(2, 4, 16, 7, 7).astype(np.float32)
    state = [(rng.randn(2, 7, 7, 8) * 0.5).astype(np.float32)
             for _ in range(2)]
    if name == "gaze_lstm":
        j_state, j_maps = jstreaming.lstm_stream_step(
            params, tuple(map(jnp.asarray, state)), jnp.asarray(chunk),
            jmodel.cfg)
        t_state, t_maps = streaming.lstm_stream_step(
            tmodel, tuple(map(torch.from_numpy, state)),
            torch.from_numpy(chunk))
    else:
        j_state, j_maps = jstreaming.grcn_stream_step(
            params, jnp.asarray(state[0]), jnp.asarray(chunk), jmodel.cfg)
        t_state, t_maps = streaming.grcn_stream_step(
            tmodel, torch.from_numpy(state[0]), torch.from_numpy(chunk))
        j_state, t_state = (j_state,), (t_state,)
    for got, want in zip(t_state, j_state):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(t_maps.numpy(), np.asarray(j_maps), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_jax_bundle_streams_in_the_port(tmp_path, wire):
    """A JAX bundle with the `stream` program (its `.jaxexp` skipped)
    streams in the port as `ServingBundle.stream_step` does: the chunk
    rounded to the wire dtype, the state carried in f32."""
    jmodel, params, _ = _pair("gaze_grcn")
    jexport.save_bundle(str(tmp_path), jmodel, params, platforms=("cpu",),
                        stream_chunk_len=4, wire_dtype=wire)
    jbundle = jexport.load_bundle(str(tmp_path))
    model = load_bundle(str(tmp_path), device="cpu")
    assert model.bundle_programs["stream"]["chunk_len"] == 4
    j_state = jbundle.initial_stream_state(2)
    t_state = initial_stream_state(model, 2)
    assert t_state.dtype == torch.float32 and t_state.shape == (2, 7, 7, 8)
    rng = np.random.RandomState(5)
    for _ in range(2):
        chunk = rng.randn(2, 4, 16, 7, 7).astype(np.float32)
        j_state, j_maps = jbundle.stream_step(
            j_state, jnp.asarray(chunk).astype(jbundle.input_dtype("stream")))
        t_state, t_maps = stream_step(model, t_state, chunk)
        np.testing.assert_allclose(t_state.numpy(), np.asarray(j_state),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t_maps.numpy(), np.asarray(j_maps),
                                   rtol=1e-4, atol=1e-5)


def test_port_bundle_records_the_stream_program(tmp_path):
    """The port writes the JAX manifest's stream fields; the JAX reader
    still loads the bundle; the port's `stream_step` is the model's
    `grcn_stream_step` on the wire-rounded chunk."""
    _, _, tmodel = _pair("gaze_grcn")
    save_bundle(str(tmp_path), tmodel, wire_dtype="bfloat16",
                stream_chunk_len=4)
    with open(os.path.join(tmp_path, "manifest.json")) as f:
        meta = json.load(f)["torch_programs"]["stream"]
    assert (meta["chunk_len"], meta["state_size"], meta["wire_dtype"]) == (
        4, 8, "bfloat16")
    assert jexport.load_bundle(str(tmp_path)).programs == []
    model = load_bundle(str(tmp_path), device="cpu")
    chunk = torch.from_numpy(
        np.random.RandomState(6).randn(1, 4, 16, 7, 7).astype(np.float32))
    state = initial_stream_state(model, 1)
    got = stream_step(model, state, chunk)
    want = streaming.grcn_stream_step(tmodel, state,
                                      chunk.bfloat16().float())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stream_program_only_for_gaze_grcn(tmp_path):
    _, _, lstm = _pair("gaze_lstm")
    with pytest.raises(ValueError, match="lstm_stream_step"):
        save_bundle(str(tmp_path / "lstm"), lstm, stream_chunk_len=4)
    _, _, grcn = _pair("gaze_grcn")
    save_bundle(str(tmp_path / "plain"), grcn)
    model = load_bundle(str(tmp_path / "plain"), device="cpu")
    with pytest.raises(KeyError, match="no stream program"):
        stream_step(model, initial_stream_state(model, 1),
                    np.zeros((1, 4, 16, 7, 7), np.float32))
    with pytest.raises(ValueError, match="GazeGRCN"):
        streaming.grcn_stream_step(lstm, torch.zeros(1, 7, 7, 8),
                                   torch.zeros(1, 4, 16, 7, 7))
