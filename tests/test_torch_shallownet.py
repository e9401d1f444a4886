"""ShallowNet, its pretraining and its grafting into the gaze models, on the
CPU: the port against the JAX package in f32 where the JAX package has the
function, and the frozen-ShallowNet fault.

ShallowNet's default and 7x7 variants and the saliency loss at rtol 1e-4 /
atol 1e-5; one saliency train step (Adam after the global-norm clip, the
flip and dropout off) at rtol 1e-3 / atol 1e-5 on the updated weights,
the JAX package's gradient tolerance. The batch_norm variant normalizes
the fc layers by the statistics of the batch itself (3 images here): a
feature whose 3 values nearly agree is divided by ~sqrt(eps) = 0.03, so
f32 summation-order noise grows ~30x there; it is held at atol 2e-4
(measured max |delta| 1.15e-4 on outputs up to 2.4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recurrent_gaze_prediction_tpu.config import (
    OptimizerConfig as JOptimizerConfig)
from recurrent_gaze_prediction_tpu.models import shallownet as jsn
from recurrent_gaze_prediction_tpu.train import saliency as jsal
from recurrent_gaze_prediction_tpu_torch import registry
from recurrent_gaze_prediction_tpu_torch.cli import (pretrain_shallownet,
                                                     train_gaze)
from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
from recurrent_gaze_prediction_tpu_torch.data import synthetic
from recurrent_gaze_prediction_tpu_torch.data.prefetch import device_put_batch
from recurrent_gaze_prediction_tpu_torch.models import shallownet
from recurrent_gaze_prediction_tpu_torch.train import (
    create_train_state, load_params, make_train_step,
    restore_shallownet, save_params)
from recurrent_gaze_prediction_tpu_torch.train import saliency
from test_torch_zoo import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")


def _jax_params(variant="default", batch_norm=False, seed=0):
    params = jsn.init_params(jax.random.PRNGKey(seed), variant, batch_norm)
    rng = np.random.RandomState(seed + 1)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.endswith("_b") or k.endswith("_offset"):   # nonzero biases
            v = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("_scale"):
            v = (1 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


def _images(n=3, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 98, 98, 3).astype(np.float32),
            rng.rand(n, 49, 49).astype(np.float32))


@pytest.mark.parametrize("variant,batch_norm", [("default", False),
                                                ("7x7", False),
                                                ("default", True)])
def test_shallownet_variants_match_jax(variant, batch_norm):
    jp = _jax_params(variant, batch_norm)
    images, _ = _images()
    want = np.asarray(jsn.apply({k: jnp.asarray(v) for k, v in jp.items()},
                                jnp.asarray(images)))
    got = shallownet.apply({k: torch.tensor(v) for k, v in jp.items()},
                           torch.from_numpy(images)).numpy()
    out_hw = (7, 7) if variant == "7x7" else (49, 49)
    assert got.shape == (3, *out_hw)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=2e-4 if batch_norm else 1e-5)
    port = shallownet.init_params(variant, batch_norm)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in jp.items()}


def test_fc1_rows_follow_the_jax_flatten_order():
    """Pool3's [11,11,32] output is flattened (h, w, c) before fc1: an fc1
    that reads only row (h=2, w=5, c=7) gives the same maps in both
    packages (a port that flattened (c, h, w) would read another element
    through that row)."""
    jp = _jax_params()
    row = (2 * 11 + 5) * 32 + 7
    jp["fc1_w"] = np.zeros_like(jp["fc1_w"])
    jp["fc1_w"][row] = np.random.RandomState(4).randn(4802).astype(
        np.float32)
    images, _ = _images()
    want = np.asarray(jsn.apply({k: jnp.asarray(v) for k, v in jp.items()},
                                jnp.asarray(images)))
    got = shallownet.apply({k: torch.from_numpy(v) for k, v in jp.items()},
                           torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).max() > 0


def test_saliency_loss_and_regularizer_match_jax():
    jp = _jax_params()
    images, maps = _images()
    j_loss, j_aux = jsal.saliency_loss(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(images),
        jnp.asarray(maps), train=False)
    t_loss, t_aux = saliency.saliency_loss(
        {k: torch.from_numpy(v) for k, v in jp.items()},
        torch.from_numpy(images), torch.from_numpy(maps), train=False)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(float(t_aux["reg_loss"]),
                               float(j_aux["reg_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(t_aux["target_loss"]),
                               float(j_aux["target_loss"]), rtol=1e-4)


@pytest.mark.parametrize("max_grad_norm", [10.0, 0.0])
def test_saliency_train_step_matches_jax(max_grad_norm):
    """One step of the port's `make_saliency_train_step` (flip and dropout
    off) against the JAX package's: its optimizer (`tx` of
    `make_saliency_train_step`: the clip, or none at max_grad_norm 0, then
    Adam) on `jax.grad` of its `saliency_loss`."""
    lr = 1e-3
    jp = _jax_params()
    images, maps = _images()
    _, jtx = jsal.make_saliency_train_step(
        JOptimizerConfig(initial_learning_rate=lr, use_decay_schedule=False,
                         max_grad_norm=max_grad_norm), use_flip=False)
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    grads = jax.grad(lambda p: jsal.saliency_loss(
        p, jnp.asarray(images), jnp.asarray(maps), train=False)[0])(jparams)
    updates, _ = jtx.update(grads, jtx.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)

    step, tx = saliency.make_saliency_train_step(
        OptimizerConfig(initial_learning_rate=lr, use_decay_schedule=False,
                        max_grad_norm=max_grad_norm),
        use_flip=False, dropout_keep_prob=1.0)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in jp.items()}
    metrics = step(params, tx.init(params), torch.from_numpy(images),
                   torch.from_numpy(maps))
    assert np.isfinite(float(metrics["loss"]))
    for k in jp:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_fit_shallownet_learns_on_the_synthetic_stand_in():
    data = pretrain_shallownet.SyntheticSaliency(n=16)
    records = []
    params = saliency.fit_shallownet(
        data, opt_cfg=OptimizerConfig(initial_learning_rate=1e-3,
                                      use_decay_schedule=False),
        max_steps=8, batch_size=8, log_every=1, device="cpu",
        metric_writer=lambda step, values: records.append((step, values)))
    assert [s for s, _ in records] == list(range(1, 9))
    losses = [v["loss/train"] for _, v in records]
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]
    assert set(params) == set(shallownet.init_params())


def test_save_load_and_graft_params(tmp_path):
    """A params file round-trips, refuses to be overwritten, and grafts
    into exactly the `shallownet.*` parameters of a gaze model."""
    src = shallownet.init_params(generator=torch.Generator().manual_seed(7))
    path = str(tmp_path / "sn.pt")
    save_params(path, src)
    with pytest.raises(FileExistsError):
        save_params(path, src)
    loaded = load_params(path)
    assert all(torch.equal(loaded[k], src[k]) for k in src)

    model = registry.create_model("gaze_rnn", device="cpu", n_lstm_steps=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert restore_shallownet(model, path) is model
    for n, p in model.named_parameters():
        if n.startswith("shallownet."):
            assert torch.equal(p, src[n.split(".", 1)[1]]), n
        else:
            assert torch.equal(p, before[n]), n
    with pytest.raises(ValueError, match="no 'shallownet'"):
        restore_shallownet(registry.create_model("gaze_grcn", device="cpu"),
                           path)
    torch.save({"not": "ours"}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not a params file"):
        load_params(str(tmp_path / "other.pt"))


def _one_step_moves(name: str) -> dict:
    """Take one default train step (Adam, freeze_shallownet on in the
    config) of `name` at T=2, B=2; per parameter, whether it moved."""
    model = registry.create_model(name, device="cpu", n_lstm_steps=2,
                                  batch_size=2, compute_dtype="float32",
                                  generator=torch.Generator().manual_seed(0))
    state, tx = create_train_state(model, OptimizerConfig())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    batch = device_put_batch(
        synthetic.make_clip_windows(2, 2, seed=1, gazemap_hw=(
            model.cfg.gazemap_height, model.cfg.gazemap_width)).next_batch(2),
        CPU)
    make_train_step(model, tx, use_flip=False)(
        state, batch, torch.Generator().manual_seed(0))
    return {n: not torch.equal(p, before[n]) for n, p in state.params.items()}


def test_frozen_shallownet_fault_is_repaired():
    """The optimizer freezes `shallownet.*` by default only in a model that
    declares `has_shallownet` (the JAX package's `create_train_state`):
    gaze_framewise_shallownet's ShallowNet is the whole model and its conv
    and fc weights move after one step; gaze_rnn's and
    gaze_grcn_cascade's stay where they were, while their other weights
    move."""
    moved = _one_step_moves("gaze_framewise_shallownet")
    for layer in ("conv1_w", "conv2_w", "conv3_w", "fc1_w", "fc2_w"):
        assert moved[f"shallownet.{layer}"], layer
    for name in ("gaze_rnn", "gaze_grcn_cascade"):
        moved = _one_step_moves(name)
        sn = [n for n in moved if n.startswith("shallownet.")]
        assert sn and not any(moved[n] for n in sn), name
        assert moved["c3d_proj.proj_c3d_W"], name


def test_explicit_freeze_flag_wins():
    model = registry.create_model("gaze_framewise_shallownet", device="cpu")
    _, tx = create_train_state(model, OptimizerConfig(),
                               freeze_shallownet=True)
    assert tx.frozen == {n for n, _ in model.named_parameters()}
    model = registry.create_model("gaze_rnn", device="cpu")
    _, tx = create_train_state(model, OptimizerConfig(),
                               freeze_shallownet=False)
    assert tx.frozen == set()
    _, tx = create_train_state(
        model, OptimizerConfig(freeze_shallownet=False))
    assert tx.frozen == set()


def test_pretrain_cli_then_graft_through_train_gaze(tmp_path):
    """`cli.pretrain_shallownet` writes a params file (and refuses an
    existing --out; --dataset salicon without a SALICON tree under
    --salicon_root fails reading it, as the JAX CLI does);
    `cli.train_gaze --shallownet_pretrain` grafts it into gaze_rnn, whose
    frozen ShallowNet is then bitwise the file's after training."""
    out = str(tmp_path / "sn.pt")
    argv = ["--device", "cpu", "--max_steps", "3", "--batch_size", "4",
            "--steps_per_logprint", "1", "--out", out,
            "--train_dir", str(tmp_path / "pre")]
    assert pretrain_shallownet.main(argv) == 0
    with open(tmp_path / "pre" / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3]
    assert pretrain_shallownet.main(argv) == 1      # --out exists
    with pytest.raises(FileNotFoundError):
        pretrain_shallownet.main(["--device", "cpu", "--dataset", "salicon",
                                  "--salicon_root", str(tmp_path / "none"),
                                  "--out", str(tmp_path / "x.pt")])

    run = str(tmp_path / "rnn")
    assert train_gaze.main([
        "--device", "cpu", "--model", "gaze_rnn", "--max_steps", "2",
        "--n_lstm_steps", "2", "--batch_size", "2", "--synthetic_clips", "2",
        "--compute_dtype", "float32", "--no_prefetch",
        "--shallownet_pretrain", out, "--train_dir", run]) == 0
    saved = torch.load(os.path.join(run, "model", "2", "state.pt"),
                       weights_only=True)["params"]
    pretrained = load_params(out)
    for k, v in pretrained.items():
        assert torch.equal(saved[f"shallownet/{k}"], v), k
