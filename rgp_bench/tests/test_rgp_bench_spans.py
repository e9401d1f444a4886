"""The readers of the program's spans and counters on synthetic records: a
unit counted only where its root was recorded, a child only under a
recorded root, None where there is no root or no program records; and a
tiny traced run of each traffic generator on the CPU, whose records they
read."""

import pytest

from conftest import REPO
from rgp_bench import cell as cells
from rgp_bench import run, spans

TRAIN = ("step_host_ms.train", "forward_host_ms.train",
         "backward_host_ms.train", "optimizer_host_ms.train",
         "prefetch_wait_ms.train", "input_mb_per_step.train")
VIDEO = ("upload_host_ms.video",)


def rec(id_, name, start_ms, end_ms, parent=None, counts=None):
    return {"name": name, "start_ns": int(start_ms * 1e6),
            "end_ns": int(end_ms * 1e6), "id": id_, "parent": parent,
            "request": None, "thread": 1, "counts": counts}


# two whole steps (10 ms and 20 ms); a step the window cut (its children
# have no parent, the grandchild's parent is one of them); a put and a
# wait per batch, one put of them without its counter
RECORDS = [
    rec(2, "train.forward", 0, 3, parent=1),
    rec(3, "gaze.recurrence", 1, 2, parent=2),
    rec(4, "train.backward", 3, 7, parent=1),
    rec(5, "train.optimizer", 7, 9, parent=1),
    rec(1, "train.step", 0, 10),
    rec(7, "train.forward", 10, 15, parent=6),
    rec(8, "train.backward", 15, 25, parent=6),
    rec(9, "train.optimizer", 25, 29, parent=6),
    rec(6, "train.step", 10, 30),
    rec(10, "train.backward", 30, 31),             # cut: no root
    rec(12, "gaze.decoder", 31, 32, parent=11),
    rec(11, "train.forward", 31, 33),              # cut: no root
    rec(13, "input.wait", 0, 0.5),
    rec(14, "input.wait", 10, 11.5),
    rec(15, "input.put", 0, 4, counts={"input.bytes": 100e6}),
    rec(16, "input.put", 4, 8, counts={"input.bytes": 300e6}),
    rec(17, "input.put", 8, 9),
    rec(19, "serve.upload", 0, 6, parent=18),
    rec(18, "serve.predict", 0, 20),
    rec(20, "serve.upload", 20, 21),               # cut: no root
]
WANT = {"step_host_ms.train": 15.0, "forward_host_ms.train": 4.0,
        "backward_host_ms.train": 7.0, "optimizer_host_ms.train": 3.0,
        "prefetch_wait_ms.train": 1.0, "input_mb_per_step.train": 200.0,
        "upload_host_ms.video": 6.0}


def _reader(name):
    cell = cells.load_cell(REPO, "grcn_train_b28")
    return cells.reader(cell, name)


@pytest.mark.parametrize("name", TRAIN + VIDEO)
def test_reader_on_synthetic_records(name, monkeypatch):
    read = _reader(name).read
    monkeypatch.setattr(spans, "program_records", lambda: list(RECORDS))
    assert read(None) == pytest.approx(WANT[name])
    # no root recorded, or no records: nothing to read
    cut = [r for r in RECORDS if r["parent"] is not None
           or r["name"] in ("train.backward", "train.forward",
                            "serve.upload")]
    monkeypatch.setattr(spans, "program_records", lambda: cut)
    assert read(None) is None
    monkeypatch.setattr(spans, "program_records", lambda: None)
    assert read(None) is None


def test_children_of_recorded_roots_only():
    units = spans.roots(RECORDS, "train.step")
    assert [u["id"] for u in units] == [1, 6]
    assert [r["id"] for r in spans.children(RECORDS, units,
                                            "train.forward")] == [2, 7]
    # a grandchild is not a child; a child whose parent was cut is neither
    assert spans.children(RECORDS, units, "gaze.recurrence") == []
    assert spans.children(RECORDS, units, "gaze.decoder") == []


def test_a_program_without_records_reads_none(monkeypatch):
    from recurrent_gaze_prediction_tpu_torch.train import profiler

    monkeypatch.delattr(profiler, "records")
    assert spans.program_records() is None
    assert _reader("step_host_ms.train").read(None) is None


@pytest.mark.parametrize("workload,names", [("grcn_train_b28", TRAIN),
                                            ("grcn_int8_video", VIDEO)])
def test_a_traced_run_reports_the_program_spans(tiny_root, workload, names):
    from recurrent_gaze_prediction_tpu_torch.train import profiler

    profiler.clear()
    result = run.run_cell(tiny_root, workload, 2 ** 31 + 7, 0.5, True,
                          "cpu")
    assert result["correct"], result
    got = {n: result["metrics"][n]["value"] for n in names}
    assert all(v > 0 for v in got.values()), got
    if workload == "grcn_train_b28":
        # the tiny cell's batch after the bf16 cast: B=4, T=4 of c3d
        # [1024,7,7] and frames [98,98,3] in bf16, two f32 49x49 maps and
        # the f32 pupils
        b, t = 4, 4
        mb = b * t * (1024 * 49 * 2 + 98 * 98 * 3 * 2 + 2 * 49 * 49 * 4
                      + 4) / 1e6
        assert got["input_mb_per_step.train"] == pytest.approx(mb)
        parts = sum(got[n] for n in names[1:4])
        assert parts <= got["step_host_ms.train"]
