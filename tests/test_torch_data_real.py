"""The real-data front of the research loop: the port's `.c3d` codec, seq
chunking, gazemap preprocessing, the CRC / Hollywood2 loader and the
attention frames, against the JAX package's on the same files and arrays.

Files cross the packages both ways and read back identically (the `.c3d`
pickles byte for byte); seq, gazemap, `process_mat_file` and every stream
of `read_crc_data_sets` (crc, hollywood2, crcxh2, original-scale fixation
maps, the npz cache) are equal bit for bit. `apply_attention` (torch)
against the JAX package's PIL version: the float product at rtol 1e-5;
after the uint8 cast at most one level apart, on at most 1% of the values.
"""

import os
import pickle

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from recurrent_gaze_prediction_tpu.data import codec as jcodec
from recurrent_gaze_prediction_tpu.data import crc as jcrc
from recurrent_gaze_prediction_tpu.data import gazemap as jgazemap
from recurrent_gaze_prediction_tpu.data import seq as jseq
from recurrent_gaze_prediction_tpu.data import video as jvideo
from recurrent_gaze_prediction_tpu_torch.data import codec, crc, gazemap, seq
from recurrent_gaze_prediction_tpu_torch.data import video

N_FRAMES = 60


# ----------------------------------------------------------------- codec

@pytest.mark.parametrize("writer,reader", [(codec, jcodec), (jcodec, codec)])
def test_c3d_files_cross_the_packages(tmp_path, writer, reader):
    blobs = np.random.RandomState(0).randn(5, 512, 2, 7, 7).astype(np.float32)
    path = str(tmp_path / "clip.c3d")
    writer.write_c3d_file(path, list(blobs))
    np.testing.assert_array_equal(reader.read_c3d_file(path), blobs)
    np.testing.assert_array_equal(reader.load_c3d_for_model(path),
                                  blobs.reshape(5, 1024, 7, 7))
    blob = str(tmp_path / "w.blob")
    writer.write_binary_blob(blob, blobs[:2, :, :, :3, :3])
    np.testing.assert_array_equal(reader.read_binary_blob(blob),
                                  blobs[:2, :, :, :3, :3])


def test_c3d_writers_give_the_same_bytes(tmp_path):
    blobs = list(np.random.RandomState(1).rand(3, 1, 512, 2, 7, 7))
    codec.write_c3d_file(str(tmp_path / "port.c3d"), blobs)
    jcodec.write_c3d_file(str(tmp_path / "jax.c3d"), blobs)
    assert (tmp_path / "port.c3d").read_bytes() == \
        (tmp_path / "jax.c3d").read_bytes()
    with open(tmp_path / "port.c3d", "rb") as f:
        assert f.read(2) == b"\x80\x02"  # pickle protocol 2


@pytest.mark.parametrize("shape", [(1, 1, 512, 2, 7, 7), (1, 512, 2, 7, 7),
                                   (1, 1024, 7, 7), (3, 1, 512, 2, 7, 7)])
def test_load_c3d_for_model_keeps_the_window_axis(tmp_path, shape):
    arr = np.random.RandomState(2).rand(*shape).astype(np.float32)
    path = str(tmp_path / "clip.c3d")
    with open(path, "wb") as f:
        pickle.dump(arr, f, protocol=2)
    got = codec.load_c3d_for_model(path)
    assert got.shape == (shape[0], 1024, 7, 7)
    np.testing.assert_array_equal(got, jcodec.load_c3d_for_model(path))


def test_corrupt_files_raise_alike(tmp_path):
    blob = str(tmp_path / "w.blob")
    codec.write_binary_blob(blob, np.ones((1, 2, 1, 3, 3), np.float32))
    raw = open(blob, "rb").read()
    for cut, what in ((10, "header"), (len(raw) - 4, "payload")):
        path = str(tmp_path / f"cut_{what}.blob")
        open(path, "wb").write(raw[:cut])
        for package in (codec, jcodec):
            with pytest.raises(IOError, match=what):
                package.read_binary_blob(path)
    with pytest.raises(ValueError, match="5-D"):
        codec.write_binary_blob(blob, np.ones((2, 3)))

    c3d = str(tmp_path / "clip.c3d")
    codec.write_c3d_file(c3d, list(np.ones((2, 512, 2, 7, 7), np.float32)))
    open(c3d, "wb").write(open(c3d, "rb").read()[:100])
    errors = []
    for package in (codec, jcodec):
        with pytest.raises(Exception) as info:
            package.read_c3d_file(c3d)
        errors.append(type(info.value))
    assert errors[0] is errors[1]
    bad = str(tmp_path / "bad.c3d")
    codec.write_c3d_file(bad, list(np.ones((2, 512, 2, 5, 5), np.float32)))
    for package in (codec, jcodec):
        with pytest.raises(ValueError, match="spatial"):
            package.load_c3d_for_model(bad)


# ------------------------------------------------------- seq and gazemap

@pytest.mark.parametrize("length", [1, 10, 42, 43, 100])
def test_seq_matches_jax(length):
    data = np.random.RandomState(length).rand(length, 3, 2)
    for seq_len in (4, 42):
        got, want = seq.seq2batch(data, seq_len), jseq.seq2batch(data,
                                                                 seq_len)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        names = [f"c{i}" for i in range(length)]
        assert seq.seq2batch(names, seq_len) == jseq.seq2batch(names,
                                                               seq_len)
        streams = {"x": data, "names": names}
        got, want = seq.chunk_streams(streams, seq_len), \
            jseq.chunk_streams(streams, seq_len)
        np.testing.assert_array_equal(got["x"], want["x"])
        assert got["names"] == want["names"]
    np.testing.assert_array_equal(seq.subsample_indices(length),
                                  jseq.subsample_indices(length))
    assert (seq.SEQ_LEN, seq.FRAME_OFFSET, seq.FRAME_STRIDE) == \
        (jseq.SEQ_LEN, jseq.FRAME_OFFSET, jseq.FRAME_STRIDE)


def _onehot(rng, t, h, w, empty=()):
    raw = np.zeros((t, h, w), np.uint8)
    raw[np.arange(t), rng.randint(0, h, t), rng.randint(0, w, t)] = 1
    raw[list(empty)] = 0
    return raw


def test_gazemap_matches_jax():
    rng = np.random.RandomState(3)
    raw = _onehot(rng, 12, 36, 48, empty=(0, 4, 5))
    assert gazemap.GAZEMAP_KEYS == jgazemap.GAZEMAP_KEYS
    for hw in ((49, 49), (48, 48), (7, 7), (3, 5)):
        np.testing.assert_array_equal(gazemap.resize_onehot_tensor(raw, hw),
                                      jgazemap.resize_onehot_tensor(raw, hw))
        for g, w in zip(gazemap.fixation_points(raw, hw),
                        jgazemap.fixation_points(raw, hw)):
            np.testing.assert_array_equal(g, w)
    for key in gazemap.GAZEMAP_KEYS:
        assert gazemap.gazemap_key_and_sigma(*key) == \
            jgazemap.gazemap_key_and_sigma(*key)
    with pytest.raises(ValueError):
        gazemap.gazemap_key_and_sigma(5, 5)
    maps = raw.astype(np.float32)
    for fn in ("fill_gazemap", "fill_missing_frames"):
        np.testing.assert_array_equal(getattr(gazemap, fn)(maps.copy()),
                                      getattr(jgazemap, fn)(maps.copy()))
    with pytest.raises(ValueError):
        gazemap.fill_missing_frames(np.zeros((3, 2, 2), np.float32))
    for sigma in (0.3, 2.0, 19.0):
        np.testing.assert_array_equal(
            gazemap.apply_gaussian_filter(maps.copy(), sigma),
            jgazemap.apply_gaussian_filter(maps.copy(), sigma))


def _write_raw_mat(path, seed, orig=(36, 48), n_users=3, zero_user=False):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as mat:
        grp = mat.create_group("data")
        for ui in range(n_users):
            user = grp.create_group(f"user{ui:02d}")
            user["gazemap"] = _onehot(rng, N_FRAMES, *orig)
            user["pupilsize"] = rng.rand(N_FRAMES)
        if zero_user:
            user = grp.create_group("userzero")
            user["gazemap"] = np.zeros((N_FRAMES, *orig), np.uint8)
            user["pupilsize"] = rng.rand(N_FRAMES)


def _mat_contents(path) -> dict:
    out = {}
    with h5py.File(path, "r") as mat:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj)
        mat.visititems(visit)
    return out


@pytest.mark.parametrize("force", [False, True])
def test_process_mat_file_matches_jax(tmp_path, force):
    paths = {}
    for name, module in (("port", gazemap), ("jax", jgazemap)):
        path = str(tmp_path / f"{name}.mat")
        _write_raw_mat(path, seed=4, zero_user=True)
        with h5py.File(path, "r+") as mat:
            module.process_mat_file(mat)
            if force:  # a second pass with force recomputes every key
                module.process_mat_file(mat, force=True)
        paths[name] = path
    got, want = _mat_contents(paths["port"]), _mat_contents(paths["jax"])
    assert sorted(got) == sorted(want)
    assert "data/userzero/gazemap" not in got
    assert "data/user00/gazemap49x49" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_process_gazemap_cli_shards_like_jax(tmp_path, monkeypatch):
    from recurrent_gaze_prediction_tpu.cli import process_gazemap as jcli
    from recurrent_gaze_prediction_tpu_torch.cli import process_gazemap as cli

    monkeypatch.setenv("AGENT_ID", "1")
    done = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        folder = tmp_path / name
        folder.mkdir()
        for i in range(4):
            _write_raw_mat(str(folder / f"clip{i:02d}.mat"), seed=i,
                           n_users=1)
        assert main(["--glob", str(folder / "*.mat"), "--num_agents",
                     "2"]) == 0
        done[name] = [_mat_contents(str(folder / f"clip{i:02d}.mat"))
                      for i in range(4)]
    assert [("data/user00/gazemap49x49" in c) for c in done["port"]] == \
        [False, True, False, True]
    for got, want in zip(done["port"], done["jax"]):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


# -------------------------------------------------------- the CRC loader

def _make_root(root, clips, seed, orig):
    """The JAX tests' fake layout (`tests/test_data.py`): frame JPEGs, a
    processed gaze .mat and a `.c3d` per clip folder."""
    rng = np.random.RandomState(seed)
    for sub in ("vid_frm", "gazemap", "vid_c3d"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for clip in clips:
        fdir = os.path.join(root, "vid_frm", clip)
        os.makedirs(fdir)
        for fi in range(N_FRAMES):
            Image.fromarray(rng.randint(0, 255, (40, 50, 3)).astype(
                np.uint8)).save(os.path.join(fdir, f"{fi:06d}.jpg"))
        path = os.path.join(root, "gazemap", clip + ".mat")
        _write_raw_mat(path, seed=rng.randint(1 << 30), orig=orig)
        with h5py.File(path, "r+") as mat:
            jgazemap.process_mat_file(mat)
        blobs = rng.rand(N_FRAMES // 16, 1, 512, 2, 7, 7).astype(np.float32)
        with open(os.path.join(root, "vid_c3d", clip + ".c3d"), "wb") as f:
            pickle.dump(blobs, f, protocol=2)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpus")
    return {
        "crc": _make_root(str(base / "crc"), [f"clip{i:03d}" for i in
                                              range(6)], 0, (36, 48)),
        "hollywood2": _make_root(
            str(base / "hollywood2"),
            ["actionclipautoautotrain00001", "actionclipautoautotrain00002",
             "actioncliptest00003", "actioncliptest00004"], 1, (20, 20)),
    }


def _layouts(module, dataset, roots):
    names = ("crc", "hollywood2") if dataset == "crcxh2" else (dataset,)
    return {n: module.DatasetLayout(root=roots[n]) for n in names}


def _assert_splits_equal(got, want):
    for mode in ("train", "valid", "test"):
        g, w = getattr(got, mode), getattr(want, mode)
        assert (g is None) == (w is None), mode
        if w is None:
            continue
        assert g.clipnames == w.clipnames
        for key in ("frames", "gazemaps", "fixationmaps", "c3d", "pupils"):
            a, b = getattr(g, key), getattr(w, key)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if b.dtype == object:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=key)
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)


def test_split_foldernames_matches_jax(roots):
    for dataset in ("crc", "hollywood2"):
        got = crc.split_foldernames(dataset, crc.DatasetLayout(roots[dataset]))
        assert got == jcrc.split_foldernames(
            dataset, jcrc.DatasetLayout(roots[dataset]))
    assert crc.split_foldernames(
        "hollywood2", crc.DatasetLayout(roots["hollywood2"]))["train"] == [
            "actionclipautoautotrain00001", "actionclipautoautotrain00002"]
    with pytest.raises(NotImplementedError):
        crc.split_foldernames("salicon", crc.DatasetLayout(roots["crc"]))
    both = crc.layouts_for("crcxh2", "/data")
    assert {k: v.root for k, v in both.items()} == {
        "crc": "/data/crc", "hollywood2": "/data/hollywood2"}


@pytest.mark.parametrize("dataset,origfix", [
    ("crc", False), ("hollywood2", False), ("crcxh2", False),
    ("crcxh2", True)])
def test_read_crc_data_sets_matches_jax(roots, dataset, origfix):
    kwargs = dict(dataset=dataset, seq_len=4, fixation_original_scale=origfix,
                  parallel_jobs=2)
    got = crc.read_crc_data_sets(layouts=_layouts(crc, dataset, roots),
                                 **kwargs)
    want = jcrc.read_crc_data_sets(layouts=_layouts(jcrc, dataset, roots),
                                   **kwargs)
    assert len(got) == len(want) > 0
    _assert_splits_equal(got, want)
    if origfix:  # crc at 36x48, hollywood2 at 20x20: ragged object arrays
        assert got.train.fixationmaps.dtype == object


def test_read_crc_data_sets_cache_and_subsets_match_jax(roots, tmp_path):
    layouts = _layouts(crc, "crc", roots)
    cached = crc.read_crc_data_sets(layouts=layouts, seq_len=4,
                                    cache_dir=str(tmp_path), parallel_jobs=2)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 3 and all(f.endswith(".npz") for f in files)
    want = jcrc.read_crc_data_sets(layouts=_layouts(jcrc, "crc", roots),
                                   seq_len=4, cache_dir=str(tmp_path))
    _assert_splits_equal(cached, want)  # the JAX loader read the port's cache
    assert sorted(os.listdir(tmp_path)) == files
    _assert_splits_equal(
        crc.read_crc_data_sets(layouts=layouts, seq_len=4,
                               cache_dir=str(tmp_path)), want)
    for kwargs in (dict(split_modes="valid"), dict(max_folders=1),
                   dict(gazemap_height=7, gazemap_width=7,
                        image_height=32, image_width=32)):
        got = crc.read_crc_data_sets(layouts=layouts, seq_len=4, **kwargs)
        _assert_splits_equal(got, jcrc.read_crc_data_sets(
            layouts=_layouts(jcrc, "crc", roots), seq_len=4, **kwargs))
    with pytest.raises(ValueError, match="layouts"):
        crc.read_crc_data_sets()


# ---------------------------------------------------------------- video

def _attention_inputs(n, h, w, gh=49, gw=49, seed=5):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    maps = rng.rand(n, gh, gw).astype(np.float32)
    maps /= maps.max(axis=(1, 2), keepdims=True)
    return frames, maps


@pytest.mark.parametrize("hw", [(48, 64), (112, 171), (30, 40)])
def test_apply_attention_matches_pil(hw):
    frames, maps = _attention_inputs(6, *hw)
    # float frames: the product before any cast
    want = jvideo.apply_attention(frames.astype(np.float32), maps)
    got = video.apply_attention(torch.from_numpy(frames.astype(np.float32)),
                                torch.from_numpy(maps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # uint8 frames: truncated back to uint8 in both packages
    want8 = jvideo.apply_attention(frames, maps)
    got8 = video.apply_attention(torch.from_numpy(frames),
                                 torch.from_numpy(maps)).numpy()
    assert got8.dtype == np.uint8
    delta = np.abs(got8.astype(int) - want8.astype(int))
    assert delta.max() <= 1
    assert (delta > 0).mean() <= 0.01


def test_frame_folder_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    frame = rng.randint(0, 256, (30, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(video.resize_to_width(frame),
                                  jvideo.resize_to_width(frame))
    assert video.resize_to_width(frame, 80) is frame
    folder = tmp_path / "frames"
    folder.mkdir()
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (20, 24, 3)).astype(
            np.uint8)).save(folder / f"{i:06d}.png")
    (folder / "notes.txt").write_text("not a frame")
    for hw in (None, (10, 12)):
        np.testing.assert_array_equal(
            video.load_frame_folder(str(folder), hw),
            jvideo.load_frame_folder(str(folder), hw))
    assert video.load_frame_folder(str(tmp_path)).shape == (0, 0, 0, 3)
    # the native backend takes JPEG folders; PNG frames go through PIL in
    # both packages
    np.testing.assert_array_equal(
        video.load_frame_folder(str(folder), (10, 12), backend="native"),
        jvideo.load_frame_folder(str(folder), (10, 12), backend="native"))


def test_extract_frames_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (64, 48))
    for i in range(5):
        frame = np.zeros((48, 64, 3), np.uint8)
        frame[:, (7 * i) % 58:(7 * i) % 58 + 6] = (0, 0, 255)
        writer.write(frame)
    writer.release()
    counts = [module.extract_frames(path, str(tmp_path / name), max_frames=4)
              for name, module in (("port", video), ("jax", jvideo))]
    assert counts == [4, 4]
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


# --------------------------------------- the CLIs' --dataset crc branches

@pytest.mark.parametrize("dataset", ["crc", "hollywood2", "crcxh2"])
def test_train_gaze_load_datasets_matches_jax(roots, tmp_path, dataset):
    import argparse

    from recurrent_gaze_prediction_tpu.cli import train_gaze as jtrain
    from recurrent_gaze_prediction_tpu.config import (
        ExperimentConfig as JExperimentConfig)
    from recurrent_gaze_prediction_tpu_torch.cli import train_gaze
    from recurrent_gaze_prediction_tpu_torch.config import ExperimentConfig

    if dataset == "crcxh2":  # {data_root}/crc and {data_root}/hollywood2
        data_root = os.path.dirname(roots["crc"])
    else:
        data_root = roots[dataset]
    for max_folders in (None, 2):
        args = argparse.Namespace(data_root=data_root, max_folders=max_folders,
                                  cache_dir=str(tmp_path / "cache"))
        exps = [ExperimentConfig(), JExperimentConfig()]
        for exp in exps:
            exp.dataset = dataset
            exp.model.n_lstm_steps = 5
        _assert_splits_equal(train_gaze.load_datasets(exps[0], args),
                             jtrain.load_datasets(exps[1], args))


@pytest.mark.parametrize("numpy_protocol", [False, True])
def test_evaluate_gaze_crc_matches_jax(roots, tmp_path, numpy_protocol):
    """Both CLIs score the crc valid split from the same parameters; the
    NumPy protocol reads the fixation maps at their original 36x48."""
    from recurrent_gaze_prediction_tpu.cli import evaluate_gaze as jeval
    from recurrent_gaze_prediction_tpu_torch.cli import evaluate_gaze
    from test_torch_extract import _run_dirs

    jdir, tdir = _run_dirs(tmp_path, "gaze_grcn", out_scale=30.0)
    metrics = ["cc", "sim", "nss", "kld"] + (
        ["AUC_Judd"] if numpy_protocol else [])
    args = ["--dataset", "crc", "--data_root", roots["crc"], "--metrics",
            *metrics] + (["--numpy_protocol"] if numpy_protocol else [])
    scores = {}
    for tag, main, run, extra in (
            ("port", evaluate_gaze.main, tdir, ["--device", "cpu"]),
            ("jax", jeval.main, jdir, [])):
        out = str(tmp_path / f"eval_{tag}")
        assert main(["--train_dir", run, "--out_dir", out] + args
                    + extra) == 0
        rows = open(os.path.join(out, "scores.txt")).read().splitlines()
        scores[tag] = np.array([[float(x) for x in r.split("\t")[1:]]
                                for r in rows[1:]])
        assert rows[0].split("\t")[1:] == metrics
    assert scores["port"].shape == scores["jax"].shape
    assert len(scores["port"]) == 2 * 42  # two valid windows of T=42
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-4,
                               atol=1e-5)


def test_visualize_outputs_reads_the_real_valid_split(roots, tmp_path):
    """`eval.visualize.visualize_outputs` with `data_root` predicts the
    run's crc valid split, as the JAX package's does: the same clips and
    maps (rtol 1e-4 / atol 1e-5), and the three grids written."""
    from recurrent_gaze_prediction_tpu.eval import visualize as jvisualize
    from recurrent_gaze_prediction_tpu_torch.eval import visualize
    from test_torch_extract import _run_dirs

    jdir, tdir = _run_dirs(tmp_path, "gaze_grcn", out_scale=30.0)
    for run in (jdir, tdir):  # the runs were made on the synthetic corpus
        path = os.path.join(run, "config.json")
        with open(path) as f:
            config = f.read().replace('"synthetic"', '"crc"')
        with open(path, "w") as f:
            f.write(config)
    got = visualize.visualize_outputs(tdir, max_instances=2,
                                      data_root=roots["crc"], device="cpu")
    want = jvisualize.visualize_outputs(jdir, max_instances=2,
                                        data_root=roots["crc"])
    assert got["clipnames"] == want["clipnames"]
    np.testing.assert_array_equal(got["gt_gazemaps"], want["gt_gazemaps"])
    np.testing.assert_allclose(got["pred_gazemaps"], want["pred_gazemaps"],
                               rtol=1e-4, atol=1e-5)
    assert sorted(os.listdir(os.path.join(tdir, "visualization"))) == [
        "frames.png", "gt.png", "pred.png"]
