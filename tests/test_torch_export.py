"""The port's `cli.export_serving` and `scripts/convert_jax_checkpoint.py`
against the JAX package on the CPU, at small widths (the registry's
gaze_grcn with a projection and state of 8), f32.

  * a run of the port's `cli.train_gaze` exported by the port's CLI serves
    maps bitwise equal to a direct `save_bundle` of the same weights
    (predict, stream and fused programs);
  * a JAX `cli.train_gaze` run, converted by the script, is restored by the
    port's `cli.extract_map` (its float16 maps within one ulp of the JAX
    CLI's) and gives the JAX package's f32 maps at rtol 1e-4 / atol 1e-5;
    its optimizer moments, count and step carry over exactly, and the
    port's trainer resumes it;
  * the JAX `cli.export_serving` bundle of that run, loaded by the port,
    matches the port's export of the converted run at rtol 1e-4 / atol
    1e-5;
  * a JAX `cli.pretrain_shallownet` params file, converted, grafts into
    the port's model with the JAX values;
  * the refusals: `--int8` without `--caffemodel` returns 1, the
    calibration flags alone change nothing, a run without a checkpoint
    returns 1 (`--int8` itself: tests/test_torch_quant.py).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_gaze_prediction_tpu import registry as jregistry
from recurrent_gaze_prediction_tpu.cli import export_serving as jexport
from recurrent_gaze_prediction_tpu.cli import extract_map as jmap
from recurrent_gaze_prediction_tpu.cli import pretrain_shallownet as jpre
from recurrent_gaze_prediction_tpu.cli import train_gaze as jtrain
from recurrent_gaze_prediction_tpu.train import Checkpointer as JCheckpointer
from recurrent_gaze_prediction_tpu.train import (
    create_train_state as jcreate_train_state)
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.bridge import params_from_jax
from recurrent_gaze_prediction_tpu_torch.cli import export_serving
from recurrent_gaze_prediction_tpu_torch.cli import extract_map
from recurrent_gaze_prediction_tpu_torch.cli import train_gaze
from recurrent_gaze_prediction_tpu_torch.data import codec
from recurrent_gaze_prediction_tpu_torch.serving import (
    fused_predict_fn, initial_stream_state, load_bundle, read_manifest,
    save_bundle, stream_step)
from recurrent_gaze_prediction_tpu_torch.serving.bundle import WIRE_DTYPES
from recurrent_gaze_prediction_tpu_torch.train import (
    Checkpointer, create_train_state, load_params, restore_shallownet)
from test_torch_c3d import jax_c3d_params

CPU = ["--device", "cpu"]
T = 4
SMALL = dict(dim_cnn_proj=8, rnn_state_size=8)
RUN = ["--model", "gaze_grcn", "--dataset", "synthetic", "--max_steps", "3",
       "--n_lstm_steps", str(T), "--batch_size", "2", "--synthetic_clips",
       "4", "--compute_dtype", "float32"]
# the port's CLI also logs every step (the JAX one has no such flag)
PORT_RUN = RUN + ["--steps_per_logprint", "1"] + ["--device", "cpu"]


def _convert_module():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "convert_jax_checkpoint.py")
    spec = importlib.util.spec_from_file_location("convert_jax_checkpoint",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


convert = _convert_module()


def _small_registry(mp, reg):
    """gaze_grcn's registry defaults at SMALL widths, for a CLI run."""
    builder, defaults = reg._REGISTRY["gaze_grcn"]
    mp.setitem(reg._REGISTRY, "gaze_grcn", (builder, {**defaults, **SMALL}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX `cli.train_gaze` run, its conversion, and a run of the port's
    `cli.train_gaze`; the same small widths, 3 steps each."""
    base = tmp_path_factory.mktemp("export")
    jdir, cdir, pdir = (str(base / n) for n in ("jax", "converted", "port"))
    with pytest.MonkeyPatch.context() as mp:
        _small_registry(mp, jregistry)
        assert jtrain.main(RUN + ["--train_dir", jdir]) == 0
    assert convert.main(["--train_dir", jdir, "--out_dir", cdir]) == 0
    with pytest.MonkeyPatch.context() as mp:
        _small_registry(mp, registry)
        assert train_gaze.main(PORT_RUN + ["--train_dir", pdir]) == 0
    return base, jdir, cdir, pdir


def _inputs(b=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, T, 98, 98, 3).astype(np.float32),
            rng.randn(b, T, 1024, 7, 7).astype(np.float32))


def _bundle_maps(path, frames, c3d):
    """The bundle's predict program on the CPU, its inputs cast to the
    wire dtype as the server casts them."""
    model = load_bundle(path, device="cpu")
    wire = WIRE_DTYPES[model.bundle_programs["predict"].get(
        "wire_dtype", "float32")]
    with torch.no_grad():
        return model.predict(torch.from_numpy(frames).to(wire).float(),
                             torch.from_numpy(c3d).to(wire).float())


def _restored_jax(jdir):
    """The JAX run's model and its latest params, as its CLIs restore
    them."""
    exp = JCheckpointer.load_config(jdir)
    model = jregistry.create_model(exp.model.name, exp.model)
    state, _ = jcreate_train_state(model, exp.optimizer,
                                   jax.random.PRNGKey(0))
    ckpt = JCheckpointer(jdir)
    restored = ckpt.restore_latest(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), state))
    ckpt.close()
    return model, restored


def _restored_port(run):
    exp = Checkpointer.load_config(run)
    model = registry.create_model(exp.model.name, exp.model, device="cpu")
    state, _ = create_train_state(model, exp.optimizer)
    assert Checkpointer(run).restore_latest(state) is not None
    return model, state


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tower") / "c3d.npz")
    params = jax_c3d_params(seed=3, fc=False)
    params["conv1a_w"] = params["conv1a_w"] / 128.0
    np.savez(path, **params)
    return path


def test_export_cli_equals_direct_save_bundle(runs, tower, tmp_path):
    """The port's run through `cli.export_serving` and through a direct
    `save_bundle` of the restored weights: the same manifest and bitwise
    the same maps from every program."""
    _, _, _, pdir = runs
    cli_dir, direct_dir = str(tmp_path / "cli"), str(tmp_path / "direct")
    assert export_serving.main(
        ["--train_dir", pdir, "--out_dir", cli_dir, "--stream_chunk_len",
         "3", "--caffemodel", tower, "--fused_num_frames", "16",
         "--wire_dtype", "bfloat16", "--video_dtype", "uint8"] + CPU) == 0
    model, _ = _restored_port(pdir)
    save_bundle(direct_dir, model, wire_dtype="bfloat16", stream_chunk_len=3,
                c3d_params=export_serving.load_c3d_params(
                    tower, torch.Generator(), torch.device("cpu")),
                num_frames=16, video_dtype="uint8")
    assert read_manifest(cli_dir) == read_manifest(direct_dir)
    assert read_manifest(cli_dir)["model"]["n_lstm_steps"] == T

    frames, c3d = _inputs()
    assert torch.equal(_bundle_maps(cli_dir, frames, c3d),
                       _bundle_maps(direct_dir, frames, c3d))
    video = np.random.RandomState(2).randint(
        0, 256, (1, 16, 128, 171, 3)).astype(np.uint8)
    chunk = torch.from_numpy(c3d[:1, :3])
    out = {}
    for tag, path in (("cli", cli_dir), ("direct", direct_dir)):
        m = load_bundle(path, device="cpu")
        with torch.no_grad():
            state, logits = stream_step(m, initial_stream_state(m, 1), chunk)
            out[tag] = (state, logits, fused_predict_fn(m)(video))
    for got, want in zip(out["cli"], out["direct"]):
        assert torch.isfinite(got).all() and torch.equal(got, want)


def test_converted_jax_run_gives_jax_maps(runs, tmp_path):
    """The converted run, restored by the port, predicts the JAX run's
    maps (f32: rtol 1e-4 / atol 1e-5); its moments, count and step are
    the JAX state's, bitwise."""
    _, jdir, cdir, _ = runs
    jmodel, jstate = _restored_jax(jdir)
    model, state = _restored_port(cdir)
    assert state.step == int(jstate.step) == 3
    jopt = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
    want_moments = params_from_jax(jopt[1][0].mu), params_from_jax(
        jopt[1][0].nu)
    assert state.opt_state["count"] == int(jopt[1][0].count) == 3
    for got, want in zip((state.opt_state["mu"], state.opt_state["nu"]),
                         want_moments):
        assert set(got) == set(want)
        for name in got:
            assert torch.equal(got[name], want[name]), name

    frames, c3d = _inputs(seed=4)
    want = np.asarray(jmodel.predict(jstate.params, jnp.asarray(frames),
                                     jnp.asarray(c3d)))
    with torch.no_grad():
        got = model.predict(torch.from_numpy(frames),
                            torch.from_numpy(c3d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two clip folders of 30 frame files with `.c3d` files of 11 and 3
    windows (batched, 30 frames give 3 maps)."""
    from PIL import Image

    base = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(11)
    for name, n_windows in (("clipA", 11), ("clipB", 3)):
        (base / name).mkdir()
        for i in range(30):
            Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(base / name / f"{i:04d}.jpg")
        codec.write_c3d_file(str(base / f"{name}.c3d"), list(
            rng.rand(n_windows, 1, 512, 2, 7, 7).astype(np.float32)))
    return base


def test_port_extract_map_restores_the_converted_run(runs, clips, tmp_path):
    """`cli.extract_map` of the port on the converted run and of the JAX
    package on the JAX run: the float16 maps within one ulp."""
    _, jdir, cdir, _ = runs
    args = ["--clips_root", str(clips), "--n_lstm_steps", "8",
            "--batch_size", "2"]
    out = {}
    for tag, main, run, extra in (("port", extract_map.main, cdir, CPU),
                                  ("jax", jmap.main, jdir, [])):
        out[tag] = str(tmp_path / tag)
        assert main(["--train_dir", run, "--out_dir", out[tag]] + args
                    + extra) == 0
    for clip in ("clipA", "clipB"):
        got = np.load(os.path.join(out["port"], clip + ".gazemap.npy"))
        want = np.load(os.path.join(out["jax"], clip + ".gazemap.npy"))
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (3, 49, 49)
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
                <= ulp.astype(np.float32)).all(), clip


def test_port_trainer_resumes_the_converted_run(runs, tmp_path):
    """`cli.train_gaze` on a copy of the converted run takes step 4 from
    step 3 (one more metrics record, no restart from step 1)."""
    import shutil

    _, _, cdir, _ = runs
    run = str(tmp_path / "resumed")
    shutil.copytree(cdir, run)
    argv = list(PORT_RUN)
    argv[argv.index("--max_steps") + 1] = "4"
    with pytest.MonkeyPatch.context() as mp:
        _small_registry(mp, registry)
        assert train_gaze.main(argv + ["--train_dir", run]) == 0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if "loss/train" in line]
    assert steps == [4]
    assert Checkpointer(run).latest_step() == 4


def test_jax_export_matches_port_export(runs, tmp_path):
    """The JAX CLI's bundle of the JAX run, loaded by the port, against the
    port CLI's bundle of the converted run (bf16 on the wire)."""
    _, jdir, cdir, _ = runs
    jbundle, pbundle = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jexport.main(["--train_dir", jdir, "--out_dir", jbundle,
                         "--platforms", "cpu", "--wire_dtype",
                         "bfloat16"]) == 0
    assert export_serving.main(["--train_dir", cdir, "--out_dir", pbundle,
                                "--wire_dtype", "bfloat16"] + CPU) == 0
    frames, c3d = _inputs(seed=5)
    got = _bundle_maps(jbundle, frames, c3d).numpy()
    want = _bundle_maps(pbundle, frames, c3d).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_converted_shallownet_params_graft(tmp_path):
    """A JAX `cli.pretrain_shallownet` file (orbax), converted, grafts into
    the port's gaze_rnn with the JAX values."""
    jfile, pfile = str(tmp_path / "sn_orbax"), str(tmp_path / "sn.pt")
    assert jpre.main(["--dataset", "synthetic", "--max_steps", "2",
                      "--batch_size", "4", "--out", jfile]) == 0
    assert convert.main(["--params", jfile, "--out", pfile]) == 0
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(jfile)
    want = ckptr.restore(jfile, jax.tree_util.tree_map(
        lambda m: jax.ShapeDtypeStruct(
            m.shape, m.dtype, sharding=jax.sharding.SingleDeviceSharding(
                jax.devices("cpu")[0])),
        getattr(meta, "item_metadata", meta)))
    ckptr.close()
    loaded = load_params(pfile)
    assert set(loaded) == set(want)
    model = registry.create_model("gaze_rnn", device="cpu", n_lstm_steps=2)
    restore_shallownet(model, pfile)
    for name, t in model.shallownet.items():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(want[name]))


def test_export_refusals(runs, tower, tmp_path):
    """`--int8` without `--caffemodel` returns 1 and writes nothing; the
    calibration flags alone change nothing (the JAX CLI's behaviour); a
    run without a checkpoint returns 1."""
    _, _, _, pdir = runs
    out = str(tmp_path / "b")
    base = ["--train_dir", pdir, "--out_dir", out] + CPU
    assert export_serving.main(base + ["--int8"]) == 1
    assert export_serving.main(base + ["--int8", "--calib_videos",
                                       str(tmp_path)]) == 1
    assert not os.path.exists(out)
    assert export_serving.main(base + ["--calib_videos", str(tmp_path),
                                       "--calib_windows", "8"]) == 0
    assert sorted(read_manifest(out)["torch_programs"]) == ["predict"]
    assert not os.path.exists(os.path.join(out, "qparams_int8.npz"))
    empty = tmp_path / "no_checkpoint"
    empty.mkdir()
    with open(os.path.join(pdir, "config.json")) as f:
        (empty / "config.json").write_text(f.read())
    assert export_serving.main(["--train_dir", str(empty), "--out_dir", out]
                               + CPU) == 1
    # the jax.export flags parse and change nothing
    assert export_serving.main(base + ["--platforms", "cpu,tpu",
                                       "--static_batch"]) == 0
    assert sorted(read_manifest(out)["torch_programs"]) == ["predict"]
