"""The port's VGG-Sound data path against the JAX package's.

On ``tests/fixtures.py:make_vgg_fixture`` at 8 kHz (0.6 s files, 0.32 s
clips) plus one file shorter than a clip, the port's ``Vggsound`` items
(``__getitem__`` and the batch read ``get_batch``) are held bit for bit to
``asf_tpu.data.vggsound.Vggsound``'s in every split, with the int16
transfer on and off; ``fast_rng`` to numpy's own draws and to the JAX
package's copy; ``AsfLoader``, in the calling process and with worker
processes, to the JAX loader's length and batch order (epochs, ranks, the
ragged val batch); and the prefetcher on the CPU to the host batches it was
given.
"""

import multiprocessing
import os
import pickle
import struct

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import wavfile

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.data import fast_rng as jax_fast_rng
from asf_tpu.data import loader as jax_loader
from asf_tpu.data.vggsound import Vggsound as JaxVggsound
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import fast_rng, loader
from asf_tpu_torch.data.prefetch import Prefetcher
from asf_tpu_torch.data.sampling import item_rng
from asf_tpu_torch.data.vggsound import Vggsound, read_annotations
from fixtures import make_vgg_fixture

SR = 8000
N_CLIPS = 14  # + one short file: 15 records


@pytest.fixture(scope="module")
def vgg_root(tmp_path_factory):
    """``make_vgg_fixture``'s 14 clips and a 0.2 s one; ``all.pkl`` holds
    the 15 rows as a DataFrame, ``all_list.pkl`` as a list of dicts,
    ``val.pkl`` the first 10 rows."""
    root = str(tmp_path_factory.mktemp("vgg"))
    audio_dir, pkl = make_vgg_fixture(root, sr=SR, n_clips=N_CLIPS, clip_secs=0.6)
    short = (np.random.default_rng(2).standard_normal(int(SR * 0.2)) * 6000).astype(np.int16)
    wavfile.write(os.path.join(audio_dir, "short.wav"), SR, short)
    df = pd.concat([pd.read_pickle(pkl), pd.DataFrame([{"video": "short.mp4", "class_id": 5}])],
                   ignore_index=True)
    df.to_pickle(os.path.join(root, "all.pkl"))
    with open(os.path.join(root, "all_list.pkl"), "wb") as f:
        pickle.dump(df.to_dict("records"), f)
    df.iloc[:10].to_pickle(os.path.join(root, "val.pkl"))
    return root


def vgg_cfgs(root, int16=True, train_list="all.pkl", val_list="val.pkl", batch=4):
    """(JAX cfg, port cfg) of the same VGG-Sound data at the tiny geometry."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.DATASET = cfg.TEST.DATASET = "Vggsound"
        cfg.VGGSOUND.AUDIO_DATA_DIR = os.path.join(root, "audio")
        cfg.VGGSOUND.ANNOTATIONS_DIR = root
        cfg.VGGSOUND.TRAIN_LIST = train_list
        cfg.VGGSOUND.VAL_LIST = val_list
        cfg.VGGSOUND.TEST_LIST = val_list
        cfg.AUDIO_DATA.SAMPLING_RATE = SR
        cfg.AUDIO_DATA.CLIP_SECS = 0.32
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
        cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = batch
        cfg.DATA_LOADER.NUM_WORKERS = 3
        cfg.RNG_SEED = 7
    jcfg.TPU.INT16_TRANSFER = pcfg.GPU.INT16_TRANSFER = int16
    return jcfg, pcfg


def _assert_items_equal(got, want):
    assert got["waveform"].dtype == want["waveform"].dtype
    np.testing.assert_array_equal(got["waveform"], want["waveform"])
    assert got["n_valid"] == want["n_valid"] and got["n_valid"].dtype == np.int32
    assert got["label"]["class_id"] == want["label"]["class_id"]
    assert got["index"] == want["index"]


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("mode,epoch", [("train", 0), ("train", 1), ("val", 0), ("test", 0)])
def test_items_match_jax(vgg_root, mode, epoch, int16):
    jcfg, pcfg = vgg_cfgs(vgg_root, int16, train_list="all.pkl", val_list="all.pkl")
    jds, pds = JaxVggsound(jcfg, mode), Vggsound(pcfg, mode)
    jds.set_epoch(epoch)
    pds.set_epoch(epoch)
    views = 2 if mode == "test" else 1
    assert len(pds) == len(jds) == (N_CLIPS + 1) * views
    assert pds.int16 == jds.int16 == int16
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])
    # The batch read, with the epoch in the call, in an order of its own.
    order = np.random.default_rng(epoch).permutation(len(pds))
    for i, item in zip(order, pds.get_batch(epoch, order)):
        _assert_items_equal(item, jds[i])
    short = pds[len(pds) - 1]  # zero-padded past its 1600 samples
    assert short["n_valid"] == int(SR * 0.2) and not short["waveform"][int(SR * 0.2):].any()
    if mode == "train" and epoch == 1:  # a new epoch draws new starts
        pds.set_epoch(0)
        assert any(not np.array_equal(pds[i]["waveform"], jds[i]["waveform"])
                   for i in range(N_CLIPS))


def test_dataframe_and_list_pickles_give_the_same_records(vgg_root, tmp_path):
    frame = read_annotations(os.path.join(vgg_root, "all.pkl"))
    records = read_annotations(os.path.join(vgg_root, "all_list.pkl"))
    assert frame == records and len(records) == N_CLIPS + 1
    _, a = vgg_cfgs(vgg_root, train_list="all.pkl")
    _, b = vgg_cfgs(vgg_root, train_list="all_list.pkl")
    for x, y in zip(Vggsound(a, "train"), Vggsound(b, "train")):
        _assert_items_equal(x, y)
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"video": ["a.mp4"], "class_id": [0]}))
    with pytest.raises(TypeError, match="DataFrame or a list of dicts"):
        read_annotations(str(bad))


def test_int16_probe_turns_the_path_off_for_a_float_file(vgg_root, tmp_path):
    """One float32 file among int16 ones: the whole dataset goes float32, as
    the JAX package decides, and the items still agree."""
    root = tmp_path / "mixed"
    (root / "audio").mkdir(parents=True)
    rows = read_annotations(os.path.join(vgg_root, "all_list.pkl"))[:4]
    for i, row in enumerate(rows):
        sr, data = wavfile.read(os.path.join(vgg_root, "audio", row["video"][:-4] + ".wav"))
        wavfile.write(str(root / "audio" / (row["video"][:-4] + ".wav")), sr,
                      data.astype(np.float32) / 32768.0 if i == 2 else data)
    with open(root / "all.pkl", "wb") as f:
        pickle.dump(rows, f)
    pd.DataFrame(rows).to_pickle(str(root / "frame.pkl"))
    jcfg, _ = vgg_cfgs(str(root), train_list="frame.pkl")
    _, pcfg = vgg_cfgs(str(root), train_list="all.pkl")
    jds, pds = JaxVggsound(jcfg, "train"), Vggsound(pcfg, "train")
    assert not pds.int16 and not jds.int16
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])


def _write_wav24(path, sr, samples):
    """A mono 24-bit PCM wav file (``scipy.io.wavfile`` writes none)."""
    data = (samples.astype(np.int32) & 0xFFFFFF).astype("<u4").view(np.uint8)
    data = data.reshape(-1, 4)[:, :3].tobytes()
    fmt = struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 3, 3, 24)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt " + fmt
                + b"data" + struct.pack("<I", len(data)) + data)


def test_a_file_that_cannot_be_mapped_reads_as_jax_reads_it(vgg_root, tmp_path):
    """Under the int16 transfer a mono int16 file is memory-mapped; a 24-bit
    file past the 8 the probe reads cannot be, and is read whole into
    float32, as the JAX package reads it; the batch is rescued to float32."""
    root = tmp_path / "deep"
    (root / "audio").mkdir(parents=True)
    rows = read_annotations(os.path.join(vgg_root, "all_list.pkl"))[:10]
    for row in rows[:9]:
        name = row["video"][:-4] + ".wav"
        (root / "audio" / name).write_bytes(open(os.path.join(vgg_root, "audio", name), "rb").read())
    deep = np.random.default_rng(6).integers(-2**23, 2**23, int(SR * 0.6))
    _write_wav24(str(root / "audio" / (rows[9]["video"][:-4] + ".wav")), SR, deep)
    with open(root / "all.pkl", "wb") as f:
        pickle.dump(rows, f)
    pd.DataFrame(rows).to_pickle(str(root / "frame.pkl"))
    jcfg, _ = vgg_cfgs(str(root), train_list="frame.pkl")
    _, pcfg = vgg_cfgs(str(root), train_list="all.pkl")
    jds, pds = JaxVggsound(jcfg, "train"), Vggsound(pcfg, "train")
    assert pds.int16 and jds.int16
    items = pds.get_batch(0, range(10))
    assert items[0]["waveform"].dtype == np.int16 and items[9]["waveform"].dtype == np.float32
    for i, item in enumerate(items):
        _assert_items_equal(item, jds[i])
        _assert_items_equal(pds[i], jds[i])
    got, want = loader.collate(items), jax_loader.collate([jds[i] for i in range(10)])
    assert got["waveform"].dtype == want["waveform"].dtype == np.float32
    np.testing.assert_array_equal(got["waveform"], want["waveform"])


def test_collate_rescues_a_mixed_batch_as_jax_does():
    rng = np.random.default_rng(3)
    items = [{"waveform": (rng.standard_normal(50) * 3000).astype(np.int16) if i % 2 else
              rng.standard_normal(50).astype(np.float32),
              "n_valid": np.int32(50 - i), "label": {"class_id": i}, "index": i, "metadata": {}}
             for i in range(4)]
    got, want = loader.collate(items), jax_loader.collate(items)
    assert got["waveform"].dtype == np.float32
    for k in ("waveform", "n_valid", "index"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"]["class_id"], want["labels"]["class_id"])


def _batches(ld):
    return [(b["index"], b["waveform"], b["n_valid"], b["labels"]["class_id"]) for b in ld]


def test_fast_rng_replays_numpy_and_the_jax_copy():
    """The first ``uniform(0, delta)`` of ``default_rng(SeedSequence([seed,
    epoch, index]))`` for every lane, bit for bit, and the JAX package's
    copy bit for bit, over seeds, epochs, indices and deltas (0 included)."""
    rng = np.random.default_rng(11)
    for seed in (0, 1, 7, int(rng.integers(2**32))):
        for epoch in (0, 3, int(rng.integers(2**32))):
            idx = np.concatenate([[0, 1, 2**32 - 1], rng.integers(0, 2**32, 61)])
            deltas = rng.integers(0, 10**9, idx.size).astype(np.float64)
            deltas[:4] = 0.0
            got = fast_rng.bulk_first_uniform(seed, epoch, idx, deltas)
            want = [np.random.default_rng(np.random.SeedSequence([seed, epoch, int(i)]))
                    .uniform(0, d) for i, d in zip(idx, deltas)]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, jax_fast_rng.bulk_first_uniform(seed, epoch, idx, deltas))
            assert all(item_rng(seed, epoch, int(i)).uniform(0, d) == g
                       for i, d, g in zip(idx[:8], deltas[:8], got[:8]))
    with pytest.raises(ValueError, match="uint32"):
        fast_rng.bulk_first_uniform(0, 0, np.array([2**32]), np.array([1.0]))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("split,world", [("train", 1), ("val", 1), ("train", 2), ("val", 2)])
def test_loader_matches_jax_order(vgg_root, split, world, workers):
    """15 train records in batches of 4 (drop_last: 3 batches), 10 val (4,
    4, 2: the ragged batch kept); two ranks wrap-pad to 16 and 10. Read in
    the calling process and by 2 worker processes."""
    for rank in range(world):
        jcfg, pcfg = vgg_cfgs(vgg_root)
        pcfg.DATA_LOADER.NUM_WORKERS = workers
        for cfg in (jcfg, pcfg):
            cfg.NUM_SHARDS, cfg.SHARD_ID = world, rank
        jl, pl = jax_loader.construct_loader(jcfg, split), loader.construct_loader(pcfg, split)
        try:
            assert len(pl) == len(jl)
            for epoch in (0, 1):
                loader.shuffle_dataset(pl, epoch)
                jax_loader.shuffle_dataset(jl, epoch)
                got, want = _batches(pl), _batches(jl)
                assert len(got) == len(want) == len(pl)
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        assert a.dtype == b.dtype
                        np.testing.assert_array_equal(a, b)
            sizes = [len(b[0]) for b in got]
            if split == "val" and world == 1:
                assert sizes == [4, 4, 2]
            if split == "train":
                assert sizes == [4] * (3 if world == 1 else 2)
        finally:
            pl.close()
            jl.close()


def test_worker_processes_read_what_the_calling_process_reads_and_close(vgg_root):
    """Two epochs of the train split by 2 spawned workers equal the batches
    read in the calling process, bit for bit; a pass abandoned half way (as
    precise BN leaves one) does not leak into the next; ``close`` ends every
    worker."""
    before = set(multiprocessing.active_children())
    _, pcfg = vgg_cfgs(vgg_root)
    lds = {}
    for workers in (0, 2):
        pcfg.DATA_LOADER.NUM_WORKERS = workers
        lds[workers] = loader.construct_loader(pcfg, "train")
    procs = lds[2]
    try:
        assert procs.worker_pids() == []
        for epoch in (0, 1):
            for ld in lds.values():
                loader.shuffle_dataset(ld, epoch)
            want = _batches(lds[0])
            got = _batches(procs)
            pids = procs.worker_pids()
            assert len(pids) == 2 and os.getpid() not in pids
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            next(iter(procs))  # abandoned: the next pass starts afresh
        assert procs.worker_pids() == pids  # the workers live across passes
    finally:
        for ld in lds.values():
            ld.close()
    assert procs.worker_pids() == []
    assert set(multiprocessing.active_children()) - before == set()


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_on_cpu_yields_the_host_batches(vgg_root, depth):
    _, pcfg = vgg_cfgs(vgg_root)
    ld = loader.construct_loader(pcfg, "val")
    try:
        host = list(ld)
        with Prefetcher(host, "cpu", depth=depth) as src:
            got = list(src)
    finally:
        ld.close()
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        assert g["waveform"].dtype == torch.int16
        assert g["n_valid"].dtype == torch.int32
        assert g["labels"]["class_id"].dtype == torch.int64
        for t, a in ((g["waveform"], h["waveform"]), (g["n_valid"], h["n_valid"]),
                     (g["labels"]["class_id"], h["labels"]["class_id"]),
                     (g["index"], h["index"])):
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)


def test_prefetch_stops_early_and_raises_the_loader_error():
    def batches():
        for i in range(3):
            yield {"x": np.full(4, i)}
        raise OSError("disk gone")

    src = Prefetcher(batches(), "cpu", depth=2)
    it = iter(src)
    assert int(next(it)["x"][0]) == 0
    src.close()
    assert src._thread is None
    with Prefetcher(batches(), "cpu", depth=2) as src2, pytest.raises(OSError, match="disk gone"):
        list(src2)
