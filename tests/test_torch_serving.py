"""A bundle written by the JAX package (`save_bundle(...,
platforms=("cpu",))`) served by the port's `server_from_bundle` on the CPU:
concurrent POSTs must get the JAX model's maps back. Maps (~1/2401 each)
are held at rtol 1e-4 / atol 1e-8 in f32; a bfloat16-wire bundle rounds
the features to bf16 in both packages and computes in f32 from there, so
it is held to the same tolerance against the JAX model fed rounded input.
"""

import io
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.serving import save_bundle as j_save_bundle
from recurrent_gaze_prediction_tpu_torch.serving import (
    DynamicBatcher, server_from_bundle)

T = 3
WIDTHS = dict(dim_feature=16, dim_cnn_proj=8, rnn_state_size=8,
              n_lstm_steps=T, compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_grcn():
    model = jregistry.create_model("gaze_grcn", **WIDTHS)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params["cell"] = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.3)
                      for k, v in params["cell"].items()}
    return model, params


def _post(url, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, np.load(io.BytesIO(resp.read()))["gazemaps"]
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_port_serves_jax_bundle(tmp_path, jax_grcn, wire):
    model, params = jax_grcn
    j_save_bundle(str(tmp_path), model, params, platforms=("cpu",),
                  wire_dtype=wire)
    rng = np.random.RandomState(1)
    c3d = rng.randn(4, T, 16, 7, 7).astype(np.float32)
    frames = rng.rand(4, T, 98, 98, 3).astype(np.float32)
    fed = jnp.asarray(c3d).astype(jnp.dtype(wire)).astype(jnp.float32)
    want = np.asarray(model.predict(params, jnp.asarray(frames), fed))

    results = [None] * 4
    with server_from_bundle(str(tmp_path), device="cpu", max_batch=8,
                            max_wait_ms=200.0).start() as server:
        url = "http://%s:%d/predict" % server.address

        def one(i):
            results[i] = _post(url, frames=frames[i], c3d=c3d[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert server.batcher.requests == 4

        for i, (status, maps) in enumerate(results):
            assert status == 200
            np.testing.assert_allclose(maps, want[i], rtol=1e-4, atol=1e-8)

        # a wrong shape gets its own 400 and leaves the server serving
        status, _ = _post(url, frames=frames[0], c3d=c3d[0, :, :8])
        assert status == 400
        status, _ = _post(url, frames=frames[0][None], c3d=c3d[0][None])
        assert status == 400
        status, maps = _post(url, frames=frames[1], c3d=c3d[1])
        assert status == 200
        np.testing.assert_allclose(maps, want[1], rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("program", ["fused", "fused_int8", "stream"])
def test_unported_programs_raise(tmp_path, program):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        server_from_bundle(str(tmp_path), program=program, device="cpu")


def test_batcher_pads_to_power_of_two_buckets():
    seen = []
    barrier = threading.Barrier(3)

    def fn(x):
        seen.append(x.shape[0])
        return x * 2

    with DynamicBatcher(fn, max_batch=8, max_wait_ms=500.0) as batcher:
        out = [None] * 3

        def one(i):
            barrier.wait()
            out[i] = batcher.predict(np.full((2,), i, np.float32),
                                     timeout=30)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert seen == [4] and batcher.requests == 3 and batcher.calls == 1
    for i in range(3):
        np.testing.assert_array_equal(out[i], [2 * i, 2 * i])
