"""The plain reference against the program at tiny sizes on the CPU, both
in float32 (the program then runs its kernels' plain versions): the gaze
heads, the tower in float32 and in int8 (bitwise), and the first train
steps with the flip and dropout drawn alike."""

import copy

import pytest
import torch

from rgp_bench import weights
from rgp_bench.reference import head as ref_head
from rgp_bench.reference import precision
from rgp_bench.reference import tower as ref_tower
from rgp_bench.reference import train as ref_train
from rgp_bench.reference import video as ref_video

CFG = {
    "model": {"name": "gaze_grcn", "image_height": 98, "image_width": 98,
              "gazemap_height": 49, "gazemap_width": 49, "n_lstm_steps": 4,
              "dim_feature": 32, "dim_cnn_proj": 16, "rnn_state_size": 16,
              "loss_type": "xentropy", "dropout_keep_prob": 0.5,
              "use_flip_batch": True, "compute_dtype": "float32",
              "param_dtype": "float32"},
    "cell": "convgru",
    "c3d": {"channels": [8, 8, 16, 16, 16, 16, 16, 16], "crop": 112,
            "mean_pixel": 101.2, "video_hw": [128, 171]},
    "optimizer": {"method": "adam", "initial_learning_rate": 0.003,
                  "learning_rate_decay": 0.8, "decay_steps": 500,
                  "staircase": True, "use_decay_schedule": True,
                  "max_grad_norm": 10.0},
    "init": {"tower_b_std": 0.01, "proj_std": 0.05, "cell_std": 0.05,
             "head_std": 1.0},
}


def config(cell: str) -> dict:
    cfg = copy.deepcopy(CFG)
    cfg["cell"] = cell
    cfg["model"]["name"] = {"convgru": "gaze_grcn",
                            "convlstm": "gaze_lstm"}[cell]
    return cfg


def program_model(cfg: dict):
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import ModelConfig

    model = registry.build_model(ModelConfig(**cfg["model"]), device="cpu")
    model.load_state_dict(weights.head(cfg, 11, "cpu"))
    return model


@pytest.mark.parametrize("cell", ["convgru", "convlstm"])
@pytest.mark.parametrize("batch", [2, 9])  # 9 * 4 frames: the composed
def test_head_matches_the_program(cell, batch):   # decoder's route
    cfg = config(cell)
    model = program_model(cfg)
    c3d = torch.rand(batch, 4, 32, 7, 7, generator=torch.Generator()
                     .manual_seed(3))
    with torch.no_grad():
        got = model(None, c3d)
        maps = model.predict(None, c3d)
    want = ref_head.logits(weights.head(cfg, 11, "cpu"), cell, c3d)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    want_maps = ref_head.maps(weights.head(cfg, 11, "cpu"), cell, c3d)
    assert torch.allclose(maps, want_maps, rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def tower_case():
    from recurrent_gaze_prediction_tpu_torch.models import c3d

    params = weights.tower(CFG, 5, "cpu")
    frames = weights.videos(5, "v", (2, 32, 128, 171, 3), "cpu")
    clips = frames.reshape(4, 16, 128, 171, 3)
    return params, frames, clips, c3d.preprocess_frames(clips)


def test_tower_f32_matches_the_program(tower_case):
    from recurrent_gaze_prediction_tpu_torch.models import c3d

    params, _, clips, prog_clips = tower_case
    ref_clips = ref_tower.preprocess(clips, 112, 101.2)
    assert torch.equal(prog_clips, ref_clips)
    got = c3d.apply(params, prog_clips, feature_layer="conv5b",
                    compute_dtype=None)
    want = ref_tower.tower_f32(params, ref_clips)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)


def test_int8_tower_matches_the_program_bitwise(tower_case):
    from recurrent_gaze_prediction_tpu_torch.models import quant

    params, _, _, prog_clips = tower_case
    qparams = quant.quantize_for_pipeline(params, calib_clips=prog_clips[:2])
    scales = ref_tower.calibrate(params, prog_clips[:2], 127.0)
    for name in ref_tower.LAYERS:
        assert float(qparams[f"{name}_xscale"]) == pytest.approx(
            scales[name], rel=1e-6)
    got = quant.apply_int8(qparams, prog_clips)
    want = ref_tower.tower_int(params, scales, prog_clips, 127.0)
    assert torch.equal(got, want)
    # int4 is far from int8: the video cells' control
    int4 = ref_tower.tower_int(params, ref_tower.calibrate(
        params, prog_clips[:2], 7.0), prog_clips, 7.0)
    assert float((int4 - want).abs().max()) > 0.05 * float(want.abs().max())


def test_video_protocol_timesteps():
    assert ref_video.timesteps(160) == 10
    assert ref_video.timesteps(32) == 2
    assert ref_video.timesteps(16) == 1


def test_train_steps_match_the_program():
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state, make_train_step)

    cfg = config("convgru")
    model = program_model(cfg)
    state, tx = create_train_state(model, OptimizerConfig(
        **cfg["optimizer"]))
    step = make_train_step(model, tx)
    g = torch.Generator().manual_seed(8)
    batches = [{"c3d": torch.rand(4, 4, 32, 7, 7, generator=g),
                "gazemaps": torch.rand(4, 4, 49, 49, generator=g) + 1e-3}
               for _ in range(3)]
    gen = torch.Generator().manual_seed(21)
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad1 = {n: m / 0.1 for n, m in state.opt_state["mu"].items()}
    want = ref_train.steps(cfg, weights.head(cfg, 11, "cpu"), batches,
                           torch.Generator().manual_seed(21))
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    for name, g1 in want["grad1"].items():
        assert torch.allclose(grad1[name], g1, rtol=1e-4, atol=1e-7), name
    for name, p in want["params"].items():
        assert torch.allclose(state.params[name].detach(), p, atol=1e-5), \
            name


def test_fp8_rounds_values_in_e4m3_and_gradients_in_e5m2():
    t = torch.randn(1000, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    r = precision.fp8(t)
    bf16 = (t.detach().bfloat16().float() - t.detach()).abs().mean()
    fp8 = (r.detach() - t.detach()).abs().mean()
    assert fp8 > 4 * bf16
    grad = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    r.backward(grad)
    # the gradient in e5m2: within 2 ** -3 of the largest, relatively
    assert torch.allclose(t.grad, grad, rtol=2 ** -3,
                          atol=float(grad.abs().max()) * 2 ** -14)
    assert not torch.equal(t.grad, grad)
