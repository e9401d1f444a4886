"""The reference's research loop through the port's CLIs on the CPU, at a
tiny size: `examples/full_pipeline.py`'s eight stages (raw gaze .mat
files and .avi videos -> process_gazemap -> extract_features ->
train_gaze --dataset crc -> evaluate_gaze -> extract_map -> create_records
-> action_classification -> the attention re-extraction), each with
`--device cpu`, asserting the format at every stage boundary as that file
does. Three clips (the crc split's 60/40/rest gives one clip to each
split) of 32 frames (two C3D windows each) keep it fast.
"""

import json
import os
import pickle

import numpy as np
import pytest

from recurrent_gaze_prediction_tpu_torch.cli import (
    action_classification, create_records, evaluate_gaze, extract_features,
    extract_map, process_gazemap, train_gaze)
from recurrent_gaze_prediction_tpu_torch.data import codec

N_CLIPS = 3
N_FRAMES = 32          # two 16-frame windows
ORIG_H, ORIG_W = 36, 48
SEQ_LEN = 2
ACTION_CLASSES = ("AnswerPhone", "DriveCar", "Eat")
CPU = ["--device", "cpu"]


def _clip(i: int) -> str:
    return f"clip{i:05d}"


def synthesize_corpus(work: str, seed: int = 0) -> tuple[str, str]:
    """.avi videos and raw gaze .mat files (per-user one-hot 'gazemap' and
    'pupilsize' only), as `examples/full_pipeline.synthesize_corpus`."""
    cv2 = pytest.importorskip("cv2")
    h5py = pytest.importorskip("h5py")
    videos = os.path.join(work, "videos")
    root = os.path.join(work, "root")
    os.makedirs(videos)
    os.makedirs(os.path.join(root, "gazemap"))
    rng = np.random.RandomState(seed)
    for ci in range(N_CLIPS):
        writer = cv2.VideoWriter(
            os.path.join(videos, _clip(ci) + ".avi"),
            cv2.VideoWriter_fourcc(*"MJPG"), 10, (ORIG_W * 2, ORIG_H * 2))
        assert writer.isOpened()
        for fi in range(N_FRAMES):
            frame = rng.randint(0, 80, (ORIG_H * 2, ORIG_W * 2, 3), np.uint8)
            x = (5 * fi + 17 * ci) % (ORIG_W * 2 - 8)
            frame[:, x:x + 8] = (0, 0, 255)
            writer.write(frame)
        writer.release()
        with h5py.File(os.path.join(root, "gazemap", _clip(ci) + ".mat"),
                       "w") as mat:
            grp = mat.create_group("data")
            for ui in range(3):
                user = grp.create_group(f"user{ui:02d}")
                raw = np.zeros((N_FRAMES, ORIG_H, ORIG_W), np.uint8)
                raw[np.arange(N_FRAMES), rng.randint(0, ORIG_H, N_FRAMES),
                    rng.randint(0, ORIG_W, N_FRAMES)] = 1
                user["gazemap"] = raw
                user["pupilsize"] = rng.rand(N_FRAMES)
    return videos, root


def test_research_loop_through_the_port_clis(tmp_path):
    import h5py

    work = str(tmp_path)
    videos, root = synthesize_corpus(work)

    # 1. process_gazemap: derived keys in place
    assert process_gazemap.main(
        ["--glob", os.path.join(root, "gazemap", "*.mat"),
         "--num_agents", "1"]) == 0
    with h5py.File(os.path.join(root, "gazemap", _clip(0) + ".mat"),
                   "r") as mat:
        user = mat["data"]["user00"]
        for key in ("gazemap49x49", "gazemap48x48", "gazemap7x7",
                    "fixation", "fixation_t", "fixation_r", "fixation_c"):
            assert key in user, key
        assert user["gazemap49x49"].shape == (N_FRAMES, 49, 49)

    # 2. extract_features: .avi -> .c3d + frame folders
    c3d_dir = os.path.join(root, "vid_c3d")
    frm_dir = os.path.join(root, "vid_frm")
    assert extract_features.main(
        ["--videos_root", videos, "--out_dir", c3d_dir, "--frames_dir",
         frm_dir, "--compute_dtype", "float32", "--batch_windows", "4"]
        + CPU) == 0
    n_windows = N_FRAMES // 16
    for ci in range(N_CLIPS):
        path = os.path.join(c3d_dir, _clip(ci) + ".c3d")
        feats = codec.load_c3d_for_model(path)
        assert feats.shape == (n_windows, 1024, 7, 7)
        assert np.isfinite(feats).all()
        with open(path, "rb") as f:
            blobs = np.asarray(pickle.load(f, encoding="latin1"))
        assert blobs.shape == (n_windows, 512, 2, 7, 7)
        assert len(os.listdir(os.path.join(frm_dir, _clip(ci)))) == N_FRAMES

    # 3. train_gaze over the corpus
    train_dir = os.path.join(work, "run")
    assert train_gaze.main(
        ["--model", "gaze_grcn", "--dataset", "crc", "--data_root", root,
         "--n_lstm_steps", str(SEQ_LEN), "--batch_size", "1",
         "--max_steps", "2", "--compute_dtype", "float32", "--no_prefetch",
         "--train_dir", train_dir] + CPU) == 0
    config = json.load(open(os.path.join(train_dir, "config.json")))
    # the reference's real-data defaults, under the flags given
    assert config["optimizer"]["initial_learning_rate"] == 1e-4
    assert (config["schedule"]["steps_per_evaluation"],
            config["schedule"]["steps_per_validation"],
            config["schedule"]["steps_per_checkpoint"]) == (100, 20, 100)
    assert config["model"]["batch_size"] == 1
    assert config["dataset"] == "crc"
    assert os.listdir(os.path.join(train_dir, "model"))

    # 4. evaluate_gaze on the valid split, both protocols
    assert evaluate_gaze.main(["--train_dir", train_dir, "--data_root", root,
                               "--metrics", "cc", "sim"] + CPU) == 0
    overall = os.path.join(train_dir, "evaluation", "overall.txt")
    scores = dict(line.split(": ") for line in
                  open(overall).read().strip().splitlines())
    assert set(scores) == {"cc", "sim"}
    assert all(np.isfinite(float(v)) for v in scores.values()), scores
    assert evaluate_gaze.main(["--train_dir", train_dir, "--data_root", root,
                               "--metrics", "cc", "nss", "--numpy_protocol",
                               "--out_dir", os.path.join(work, "np_eval")]
                              + CPU) == 0

    # 5. extract_map: batched, then streamed
    maps_dir = os.path.join(work, "maps")
    assert extract_map.main(
        ["--train_dir", train_dir, "--clips_root", frm_dir, "--c3d_root",
         c3d_dir, "--out_dir", maps_dir, "--n_lstm_steps", "8",
         "--batch_size", "2"] + CPU) == 0
    stream_dir = os.path.join(work, "maps_streamed")
    assert extract_map.main(
        ["--train_dir", train_dir, "--clips_root", frm_dir, "--c3d_root",
         c3d_dir, "--out_dir", stream_dir, "--streaming", "--chunk_len",
         "1"] + CPU) == 0
    for out in (maps_dir, stream_dir):
        for ci in range(N_CLIPS):
            maps = np.load(os.path.join(out, _clip(ci) + ".gazemap.npy"))
            small = np.load(os.path.join(out, _clip(ci) + ".gazemap7x7.npy"))
            assert maps.dtype == np.float16 and maps.shape[1:] == (49, 49)
            assert small.shape == (len(maps), 7, 7)
            assert np.isfinite(maps).all()

    # 6. create_records with ClipSets labels
    clipsets = os.path.join(work, "ClipSets")
    os.makedirs(clipsets)
    for k, action in enumerate(ACTION_CLASSES):
        for split in ("train", "test"):
            with open(os.path.join(clipsets, f"{action}_{split}.txt"),
                      "w") as f:
                for ci in range(N_CLIPS):  # every clip has a class
                    f.write(f"{_clip(ci)} {1 if (ci + k) % 2 == 0 else -1}\n")
    records_dir = os.path.join(work, "records")
    assert create_records.main(
        ["--train_dir", train_dir, "--out_dir", records_dir, "--split",
         "train", "--data_root", root, "--clipsets_dir", clipsets]
        + CPU) == 0
    shards = sorted(os.listdir(records_dir))
    assert shards
    with np.load(os.path.join(records_dir, shards[0])) as shard:
        assert set(shard.files) >= {"c3d", "frames", "gaze_pred", "gaze_gt",
                                    "labels"}
        assert shard["c3d"].shape[1:] == (1024, 7, 7)
        assert shard["gaze_pred"].shape[1:] == (49, 49)
        assert shard["labels"].shape[1:] == (13,)

    # 7. action_classification with gaze attention
    scores_json = os.path.join(work, "action_scores.json")
    assert action_classification.main(
        ["--records_glob", os.path.join(records_dir, "train-*.npz"),
         "--head", "NN", "--use_gazemap", "--batch_size", "2",
         "--max_iter", "5", "--out", scores_json] + CPU) == 0
    action_scores = json.load(open(scores_json))
    assert 0.0 <= action_scores["hamming_loss"] <= 1.0
    assert np.isfinite(action_scores["mean_average_precision"])

    # 8. the attention variant: re-extraction with the exported maps
    att_dir = os.path.join(work, "vid_c3d_att")
    assert extract_features.main(
        ["--videos", os.path.join(videos, _clip(0) + ".avi"), "--out_dir",
         att_dir, "--attention_maps_root", maps_dir, "--compute_dtype",
         "float32", "--batch_windows", "4"] + CPU) == 0
    att = codec.load_c3d_for_model(os.path.join(att_dir, _clip(0) + ".c3d"))
    plain = codec.load_c3d_for_model(os.path.join(c3d_dir,
                                                  _clip(0) + ".c3d"))
    assert att.shape == plain.shape
    assert not np.allclose(att, plain), "attention had no effect"
