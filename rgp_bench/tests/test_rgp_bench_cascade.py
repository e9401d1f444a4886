"""The two cells of the cascade and of raw-video training on the CPU: the
program's cascade against `reference/cascade.py` at B=2, T=3 and full
widths on seeded weights (the maps, the first step's loss and gradients,
the parameters after 3 Adam steps), raw-video training against
`reference/fused_train.py` at F=32, `correct` refusing every planted
fault, the cascade's count of contractions against one by hand, and the
new per-layer readers on synthetic records."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from conftest import REPO
from rgp_bench import run, span_tree, spans, weights, weights_cascade
from rgp_bench.counts import c3d as c3d_counts
from rgp_bench.counts import cascade, gaze
from rgp_bench.reference import cascade as ref_cascade
from rgp_bench.reference import fused_train as ref_fused

SEED = 2**31 + 97
LR = 1e-4
CASCADE = json.loads((REPO / "rgp_bench" / "configs" /
                      "gaze_grcn_cascade.json").read_text())
GRCN = json.loads((REPO / "rgp_bench" / "configs" / "gaze_grcn.json")
                  .read_text())


def _cascade_cfg(t: int = 3) -> dict:
    cfg = copy.deepcopy(CASCADE)
    cfg["model"].update(n_lstm_steps=t, compute_dtype="float32")
    return cfg


def _cascade_model(cfg: dict):
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import ModelConfig

    model = registry.build_model(ModelConfig(**cfg["model"]), device="cpu")
    model.load_state_dict(weights_cascade.params(cfg, 11, "cpu"))
    return model


def _features(g, b=2, t=3):
    return torch.randn(b, t, 1024, 7, 7, generator=g).relu_() * 10


def test_cascade_maps_match_the_program():
    cfg = _cascade_cfg()
    model = _cascade_model(cfg)
    c3d = _features(torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(None, c3d)
    want = ref_cascade.maps(weights_cascade.params(cfg, 11, "cpu"), c3d)
    assert model.last_route == "scan"
    # both in float32: the convs and the 7203-long fc rows summed in
    # another order, ~1e-6 of maps that reach ~3
    assert torch.allclose(got, want, rtol=1e-5, atol=2e-5)


def test_cascade_train_steps_match_the_program():
    from recurrent_gaze_prediction_tpu_torch.config import OptimizerConfig
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state, make_train_step)

    cfg = _cascade_cfg()
    assert cfg["optimizer"]["initial_learning_rate"] == LR
    model = _cascade_model(cfg)
    state, tx = create_train_state(model, OptimizerConfig(
        **cfg["optimizer"]))
    step = make_train_step(model, tx)
    g = torch.Generator().manual_seed(8)
    batches = [{"c3d": _features(g),
                "gazemaps": torch.rand(2, 3, 49, 49, generator=g) + 1e-3}
               for _ in range(3)]
    gen = torch.Generator().manual_seed(21)
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad1 = {n: m / 0.1 for n, m in state.opt_state["mu"].items()}
    start = weights_cascade.params(cfg, 11, "cpu")
    want = ref_cascade.steps(cfg, weights_cascade.params(cfg, 11, "cpu"),
                             batches, torch.Generator().manual_seed(21),
                             weights_cascade.frozen)
    # float32 on both sides: the first loss (~700) to a few ulps; the
    # later ones follow Adam's first updates, which move elements with
    # near-zero gradients by +-lr as rounding picks their signs (~1e-4)
    assert losses[0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert losses == pytest.approx(want["losses"], rel=1e-3)
    assert set(grad1) == set(want["grad1"]) == {
        n for n in start if not weights_cascade.frozen(n)}
    for name, g1 in want["grad1"].items():
        # every leaf's gradient to ~2e-6 of its largest element
        assert torch.allclose(grad1[name], g1, rtol=1e-4,
                              atol=1e-5 * float(g1.abs().max())), name
    for name, p in want["params"].items():
        got = state.params[name].detach()
        if weights_cascade.frozen(name):
            assert torch.equal(got, start[name]), name
            continue
        # Adam moves an element by about the learning rate whatever its
        # gradient's size, so where a later step's gradient nearly cancels
        # the rounding of its sums picks the sign of the step: each leaf's
        # change over the three steps within 5% of the reference's in norm
        # (1.6% at most on these inputs), and no element further apart than
        # the three steps reach
        _same_change(got - start[name], p - start[name], name)


def _same_change(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    assert float(want.norm()) > 0, name
    assert float((got - want).norm()) <= 5e-2 * float(want.norm()), name
    assert float((got - want).abs().max()) <= 2 * 3 * LR, name


TINY_TOWER = [8, 8, 16, 16, 16, 16, 16, 512]


def test_fused_train_steps_match_the_program():
    """Raw-video training at F=32 (T=2), the tower frozen, both in
    float32."""
    from recurrent_gaze_prediction_tpu_torch import registry
    from recurrent_gaze_prediction_tpu_torch.config import (ModelConfig,
                                                            OptimizerConfig)
    from recurrent_gaze_prediction_tpu_torch.models import pipeline
    from recurrent_gaze_prediction_tpu_torch.train.fused import (
        FusedTrainState)
    from recurrent_gaze_prediction_tpu_torch.train.state import (
        create_train_state)

    cfg = copy.deepcopy(GRCN)
    cfg["model"].update(dim_cnn_proj=16, rnn_state_size=16,
                        compute_dtype="float32")
    cfg["c3d"]["channels"] = TINY_TOWER
    model = registry.build_model(ModelConfig(**cfg["model"]), device="cpu")
    model.load_state_dict(weights.head(cfg, 11, "cpu"))
    tower = weights.tower(cfg, 11, "cpu")
    gaze_state, tx = create_train_state(model, OptimizerConfig(
        **cfg["optimizer"]))
    state = FusedTrainState(params=gaze_state.params,
                            opt_state=pipeline.init_fused_opt_state(
                                tx, gaze_state.params), c3d_params=tower)
    step = pipeline.make_fused_train_step(model, tx, compute_dtype=None)
    g = torch.Generator().manual_seed(8)
    batches = [{"video": weights.videos(SEED, f"v{i}", (4, 32, 128, 171, 3),
                                        "cpu"),
                "gazemaps": torch.rand(4, 2, 49, 49, generator=g) + 1e-3}
               for i in range(3)]
    gen = torch.Generator().manual_seed(21)
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad1 = {n: m / 0.1 for n, m in state.opt_state["mu"].items()}
    want = ref_fused.steps(cfg, weights.tower(cfg, 11, "cpu"),
                           weights.head(cfg, 11, "cpu"), batches,
                           torch.Generator().manual_seed(21))
    # float32 throughout, the tower's and the head's sums in another order;
    # the later losses as in the cascade's test
    assert losses[0] == pytest.approx(want["losses"][0], rel=1e-5)
    assert losses == pytest.approx(want["losses"], rel=1e-3)
    for name, g1 in want["grad1"].items():
        assert torch.allclose(grad1[name], g1, rtol=1e-4,
                              atol=1e-5 * float(g1.abs().max())), name
    start = weights.head(cfg, 11, "cpu")
    for name, p in want["params"].items():
        got = state.params[name].detach() - start[name]
        # as in the cascade's test, at gaze_grcn's learning rate 3e-3
        assert float((got - (p - start[name])).norm()) <= 5e-2 * float(
            (p - start[name]).norm()), name


def _run(root, workload, variant="program"):
    return run.run_cell(root, workload, SEED, 0.5, False, "cpu",
                        variant=variant)


def _tiny(root):
    """The shrunk benchmark with raw-video training at F=32 and the
    cascade in float32: at the shrunk widths (P=16, B=4, T=4) the
    cascade's bfloat16 `grad_diff` on the CPU reads 0.05-0.07, near the
    limit set from the card's readings at full widths (0.016-0.025
    there); the card's runs hold bfloat16 to it."""
    path = root / "rgp_bench" / "traffic" / "fused_train_b8.json"
    traffic = json.loads(path.read_text())
    traffic["frames"] = 32
    path.write_text(json.dumps(traffic))
    path = root / "rgp_bench" / "configs" / "gaze_grcn_cascade.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["compute_dtype"] = "float32"
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("workload", ["cascade_train_b28",
                                      "grcn_fused_train_b8"])
def test_sound_program_is_correct_and_each_reference_fault_is_not(
        tiny_root, workload):
    root = _tiny(tiny_root)
    sound = _run(root, workload)
    assert sound["correct"], sound["checks"]
    if workload == "cascade_train_b28":
        assert sound["notes"]["route"] == "scan"
        assert sound["notes"]["frozen_change"] == 0.0
    for variant in ("control", "half_batch", "double_grad", "unchanged"):
        out = _run(root, workload, variant)
        assert not out["correct"], (variant, out["checks"])


def _unchanged(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.train import state

    monkeypatch.setattr(state.Optimizer, "apply",
                        lambda self, params, grads, opt_state, norm=None:
                        None)


def _half_rows(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.models import pipeline
    from recurrent_gaze_prediction_tpu_torch.train import state

    real = state.loss_and_grads

    def half(model, params, batch, generator):
        b = next(iter(batch.values())).shape[0]
        return real(model, params, {k: v[:b // 2] for k, v in batch.items()},
                    generator)

    monkeypatch.setattr(state, "loss_and_grads", half)
    real_fused = pipeline.make_fused_grads_fn

    def fused(loss_fn, **kw):
        grads = real_fused(loss_fn, **kw)

        def half_fused(gaze_params, c3d_params, batch, generator):
            b = next(iter(batch.values())).shape[0]
            return grads(gaze_params, c3d_params,
                         {k: v[:b // 2] for k, v in batch.items()},
                         generator)
        return half_fused

    monkeypatch.setattr(pipeline, "make_fused_grads_fn", fused)


def _doubled_grad(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.models import pipeline
    from recurrent_gaze_prediction_tpu_torch.train import state

    real = state.loss_and_grads

    def doubled(model, params, batch, generator):
        loss, grads = real(model, params, batch, generator)
        return loss, [grads[0] * 2] + grads[1:]

    monkeypatch.setattr(state, "loss_and_grads", doubled)
    real_fused = pipeline.make_fused_grads_fn

    def fused(loss_fn, **kw):
        grads = real_fused(loss_fn, **kw)

        def doubled_fused(*args):
            loss, g = grads(*args)
            first = next(iter(g))
            return loss, {**g, first: g[first] * 2}
        return doubled_fused

    monkeypatch.setattr(pipeline, "make_fused_grads_fn", fused)


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _doubled_grad],
                         ids=["state_unchanged", "half_batch",
                              "gradient_altered"])
@pytest.mark.parametrize("workload", ["cascade_train_b28",
                                      "grcn_fused_train_b8"])
def test_program_faults_are_refused(tiny_root, monkeypatch, fault,
                                    workload):
    fault(monkeypatch)
    result = _run(_tiny(tiny_root), workload)
    assert not result["correct"], result["checks"]


def test_cascade_contractions_by_hand():
    parts = cascade.forward_parts(CASCADE["model"], CASCADE["cascade"])
    # per frame, MFLOP: 51 + 347 + 173 + 194 + 72 + 92 = 930
    assert parts == {
        "projection": 51_380_224,        # 2 * 49 * 1024 * 512
        "bottom_input": 346_816_512,     # 2 * 49 * 9 * 512 * 768
        "bottom_state": 173_408_256,     # 2 * 49 * 9 * 256 * 768
        "upsample": 194_281_472,         # 2 * 49 * 121 * 256 * 64
        "top_input": 69_148_800,         # 2 * 2401 * 25 * 64 * 9
        "top_state": 3_241_350,          # 2 * 2401 * 25 * 3 * 9
        "fc_head": 92_236_816}           # 2 * 7203 * 4802 + 2 * 2401 * 4802
    assert sum(parts.values()) == 930_513_430
    frames = 28 * 42
    assert cascade.forward_ops(CASCADE["model"], CASCADE["cascade"],
                               frames) == frames * 930_513_430
    # the backward: every weight's gradient, every input's but the
    # projection's: 3.22 TFLOP a step of B=28, T=42
    train = cascade.train_ops(CASCADE["model"], CASCADE["cascade"], frames)
    assert train == frames * (2 * 51_380_224 + 3 * 879_133_206)
    assert train == pytest.approx(3.2225e12, rel=1e-4)


def _ctx(shapes, units=10, window_s=2.0):
    from rgp_bench.cell import Context

    return Context(cell=None, window_s=window_s, units=units, shapes=shapes,
                   spans={})


def test_mfu_readers():
    from rgp_bench import cell as cells

    casc = cells.load_module(REPO / "rgp_bench" / "metrics" /
                             "mfu.cascade.train.py", "t_mfu_cascade")
    shapes = {"batch": 28, "timesteps": 42, "model": CASCADE["model"],
              "cascade": CASCADE["cascade"], "cell": "cascade"}
    assert casc.read(_ctx(shapes)) == pytest.approx(
        100 * 5 * 3.2225e12 / 989e12, rel=1e-4)
    assert casc.read(_ctx(dict(shapes, cell="convgru"))) is None
    fused = cells.load_module(REPO / "rgp_bench" / "metrics" /
                              "mfu.fused.train.py", "t_mfu_fused")
    shapes = {"batch": 8, "timesteps": 10, "clips": 80, "crop": 112,
              "model": GRCN["model"], "cell": "convgru",
              "c3d_channels": GRCN["c3d"]["channels"]}
    ops = c3d_counts.ops(GRCN["c3d"]["channels"], 80) + gaze.train_ops(
        GRCN["model"], "convgru", 80)
    assert fused.read(_ctx(shapes)) == pytest.approx(
        100 * 5 * ops / 989e12)
    assert fused.read(_ctx(shapes, units=0)) is None


def _record(i, name, parent, ms=1.0, counts=None):
    return {"id": i, "name": name, "parent": parent, "start_ns": 0,
            "end_ns": int(ms * 1e6), "request": 1, "thread": 1,
            "counts": counts}


def test_span_readers_at_any_depth(monkeypatch):
    from rgp_bench import cell as cells

    recs = [_record(1, "train.step", None, 300),
            _record(2, "train.forward", 1, 100),
            _record(3, "gaze.recurrence", 2, 40,
                    {"recurrence.plain_steps": 42}),
            _record(4, "gaze.top_recurrence", 2, 30,
                    {"recurrence.plain_steps": 42}),
            _record(5, "train.step", None, 300),
            _record(6, "train.forward", 5, 100),
            _record(7, "gaze.recurrence", 6, 20,
                    {"recurrence.plain_steps": 42}),
            _record(8, "gaze.top_recurrence", 6, 10,
                    {"recurrence.plain_steps": 42}),
            # opened inside a step the window cut: its root is unrecorded
            _record(9, "gaze.recurrence", 99, 500,
                    {"recurrence.plain_steps": 42})]
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    read = {name: cells.load_module(
        REPO / "rgp_bench" / "metrics" / f"{name}.py", f"t_{i}").read
        for i, name in enumerate(("recurrence_host_ms.train",
                                  "top_recurrence_host_ms.train",
                                  "plain_scan_steps.train"))}
    assert read["recurrence_host_ms.train"](None) == pytest.approx(30.0)
    assert read["top_recurrence_host_ms.train"](None) == pytest.approx(20.0)
    assert read["plain_scan_steps.train"](None) == 84.0
    # a program with no such spans or counter (the one before them)
    bare = [r for r in recs if r["name"].startswith("train.")]
    bare = [dict(r, counts=None) for r in bare]
    monkeypatch.setattr(spans, "program_records", lambda: bare)
    assert all(fn(None) is None for fn in read.values())
    monkeypatch.setattr(spans, "program_records", lambda: None)
    assert all(fn(None) is None for fn in read.values())
    assert span_tree.by_unit([], "train.step") == {}
