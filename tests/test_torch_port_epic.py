"""The port's EPIC-KITCHENS-100 verb/noun path against the JAX package's.

A synthetic EPIC set at 8 kHz (3 videos of 6 s, int16 noise): the JAX
package reads the audio from an HDF5 archive, the port from a directory of
per-video wav files holding the same samples; the annotations are
DataFrames indexed by ``narration_id`` on the JAX side and lists of dicts
that carry it on the port's (the port reads both). Rows mix actions longer
than the 0.32 s clip, shorter ones, one that runs past its video's end, one
with ``stop <= start``, and in the ``aug`` list rows with a
``transformation``. On these: the items and batches bit for bit, the loader
order, the multi-task head, the meters, the fine-tune checkpoint load,
``train(cfg)`` and ``test(cfg)`` (the tiny depth-26 SlowFast of
``test_torch_port_loop.py`` with 6 verbs and 8 nouns, float32, the JAX side
with ``ASF_MAXPOOL_SAS_BWD=1`` as that file explains) and ``run_net``.
"""

import os
import pickle

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.io import wavfile

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.data import loader as jax_loader
from asf_tpu.data.epickitchens import EpicKitchens as JaxEpicKitchens
from asf_tpu.engine import meters as jax_meters
from asf_tpu.engine import train as jax_train
from asf_tpu.engine.steps import make_input_pipeline as jax_pipeline
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu.models import build_model as jax_build_model
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import loader
from asf_tpu_torch.data.epickitchens import EpicKitchens
from asf_tpu_torch.data.vggsound import read_annotations
from asf_tpu_torch.engine import meters
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.engine.steps import init_state
from asf_tpu_torch.models import build_model
from asf_tpu_torch.tools import run_net
from test_torch_port_loop import _model_cfg, _rel_l2, _untimed, captured
from test_torch_port_loop import jitted_jax_init  # noqa: F401  (fixture)

SR = 8000
CLIP_SECS = 0.32  # 2559 samples a clip
VIDEOS, VIDEO_SECS = 3, 6.0
VIEWS = 3
CLASSES = [6, 8]
TRANSFORMS = ("polarity_inversion", "gaussian_noise", "pitch_shift")
SCORE_TOL = 1e-5


def _ts(seconds: float) -> str:
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{s:05.2f}"


def _rows(n: int, first: int, transformed: bool) -> list:
    """``n`` annotation rows: durations cycle through 1.0 s, 0.2 s (shorter
    than a clip), 0.5 s and 0.3 s; row 5 runs past its video's end, row 6
    stops before it starts; with ``transformed`` every third row names a
    transformation (the others have no such key)."""
    rows = []
    for r in range(n):
        start = 0.25 + 0.61 * ((first + r) % 9)
        stop = start + (1.0, 0.2, 0.5, 0.3)[r % 4]
        if r == 5:  # every clip of it ends past the video
            start, stop = VIDEO_SECS - 0.2, VIDEO_SECS + 0.3
        if r == 6:
            stop = start - 0.1
        row = {"narration_id": f"P01_{first + r:03d}", "participant_id": "P01",
               "video_id": f"P01_{(first + r) % VIDEOS:02d}",
               "start_timestamp": _ts(start), "stop_timestamp": _ts(stop),
               "verb_class": (first + r) % CLASSES[0], "noun_class": (3 * r + first) % CLASSES[1]}
        if transformed and r % 3 == 1:
            row["transformation"] = TRANSFORMS[(r // 3) % 3]
        rows.append(row)
    return rows


@pytest.fixture(scope="module")
def epic_root(tmp_path_factory):
    """``audio/<video>.wav`` and ``EPIC_audio.hdf5`` with the same int16
    samples; for each list ``<name>.pkl`` (a DataFrame indexed by
    ``narration_id``) and ``<name>_list.pkl`` (its rows as dicts)."""
    root = tmp_path_factory.mktemp("epic")
    (root / "audio").mkdir()
    rng = np.random.default_rng(0)
    with h5py.File(root / "EPIC_audio.hdf5", "w") as f:
        for v in range(VIDEOS):
            wave = (rng.standard_normal(int(SR * VIDEO_SECS)) * 4000).astype(np.int16)
            wavfile.write(str(root / "audio" / f"P01_{v:02d}.wav"), SR, wave)
            f.create_dataset(f"P01_{v:02d}", data=wave)
    for name, n, first, transformed in (("train", 16, 0, False), ("aug", 16, 0, True),
                                        ("val", 10, 20, False), ("test", 6, 40, False)):
        rows = _rows(n, first, transformed)
        with open(root / f"{name}_list.pkl", "wb") as f:
            pickle.dump(rows, f)
        frame = pd.DataFrame([{k: v for k, v in row.items() if k != "narration_id"}
                              for row in rows], index=[row["narration_id"] for row in rows])
        if transformed:
            frame["transformation"] = frame["transformation"].fillna("none")
        frame.to_pickle(root / f"{name}.pkl")
    return str(root)


def epic_cfgs(root, train_list="train", int16=True, batch=4, source="wav"):
    """(JAX cfg, port cfg) of the same EPIC data: the JAX package reads the
    HDF5 archive and DataFrames, the port the lists and the wav directory
    (``source`` "wav") or the same archive ("archive")."""
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    port_audio = {"wav": "audio", "archive": "EPIC_audio.hdf5"}[source]
    for cfg, audio, suffix in ((jcfg, "EPIC_audio.hdf5", ""), (pcfg, port_audio, "_list")):
        cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchens"
        cfg.EPICKITCHENS.AUDIO_DATA_FILE = os.path.join(root, audio)
        cfg.EPICKITCHENS.ANNOTATIONS_DIR = root
        cfg.EPICKITCHENS.PROCESSED_TRAIN_LIST = f"{train_list}{suffix}.pkl"
        cfg.EPICKITCHENS.PROCESSED_VAL_LIST = f"val{suffix}.pkl"
        cfg.EPICKITCHENS.PROCESSED_TEST_LIST = f"test{suffix}.pkl"
        cfg.AUDIO_DATA.SAMPLING_RATE = SR
        cfg.AUDIO_DATA.CLIP_SECS = CLIP_SECS
        cfg.TEST.NUM_ENSEMBLE_VIEWS = VIEWS
        cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = batch
        cfg.DATA_LOADER.NUM_WORKERS = 2
        cfg.RNG_SEED = 7
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    jcfg.TPU.INT16_TRANSFER = pcfg.GPU.INT16_TRANSFER = int16
    return jcfg, pcfg


def _assert_items_equal(got, want):
    assert got["waveform"].dtype == want["waveform"].dtype
    np.testing.assert_array_equal(got["waveform"], want["waveform"])
    assert got["n_valid"] == want["n_valid"] and got["n_valid"].dtype == np.int32
    assert got["label"] == want["label"]
    assert got["index"] == want["index"]
    assert got["metadata"] == want["metadata"]


# -- items -----------------------------------------------------------------------

@pytest.mark.parametrize("source", ["wav", "archive"])
@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("split,train_list,epoch", [
    ("train", "train", 0), ("train", "train", 1), ("train", "aug", 0), ("val", "train", 0),
    ("test", "train", 0), ("train+val", "aug", 1),
])
def test_items_match_jax(epic_root, split, train_list, epoch, int16, source):
    jcfg, pcfg = epic_cfgs(epic_root, train_list, int16, source=source)
    jds, pds = JaxEpicKitchens(jcfg, split), EpicKitchens(pcfg, split)
    jds.set_epoch(epoch)
    pds.set_epoch(epoch)
    assert len(pds) == len(jds) == {"train": 16, "val": 10, "test": 6 * VIEWS,
                                    "train+val": 26}[split]
    assert pds.int16 == jds.int16 == (int16 and train_list == "train")
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])
    order = np.random.default_rng(epoch).permutation(len(pds))
    for i, item in zip(order, pds.get_batch(epoch, order)):
        _assert_items_equal(item, jds[i])
    n_valid = [int(pds[i]["n_valid"]) for i in range(len(pds))]
    assert min(n_valid) < pds.clip_samples  # short actions take the n_valid path
    if split == "train":
        short = pds[1]  # 0.2 s: 1600 samples, zeros after
        assert short["n_valid"] == 1600 and not short["waveform"][1600:].any()
        assert pds[6]["n_valid"] == 0 and not pds[6]["waveform"].any()  # stop < start
        assert not pds[5]["waveform"][-900:].any()  # past the video's end
        assert {pds[i]["metadata"]["narration_id"] for i in range(16)} == {
            f"P01_{r:03d}" for r in range(16)}


def test_single_batch_keeps_the_first_rows_of_each_list(epic_root):
    jcfg, pcfg = epic_cfgs(epic_root, "aug", batch=3)
    for cfg in (jcfg, pcfg):
        cfg.EPICKITCHENS.SINGLE_BATCH = True
    jds, pds = JaxEpicKitchens(jcfg, "train+val"), EpicKitchens(pcfg, "train+val")
    assert len(pds) == len(jds) == 6
    for i, item in enumerate(pds.get_batch(0, range(6))):
        _assert_items_equal(item, jds[i])


def test_annotations_keep_their_narration_ids(epic_root, tmp_path):
    frame = read_annotations(os.path.join(epic_root, "aug.pkl"), index_key="narration_id")
    rows = read_annotations(os.path.join(epic_root, "aug_list.pkl"), index_key="narration_id")
    assert [r["narration_id"] for r in frame] == [r["narration_id"] for r in rows] == [
        f"P01_{i:03d}" for i in range(16)]
    assert "narration_id" not in read_annotations(os.path.join(epic_root, "aug.pkl"))[0]
    _, pcfg = epic_cfgs(epic_root, "aug")
    a = EpicKitchens(pcfg, "train")
    pcfg.EPICKITCHENS.PROCESSED_TRAIN_LIST = "aug.pkl"  # the DataFrame
    b = EpicKitchens(pcfg, "train")
    for i in range(len(a)):
        _assert_items_equal(a[i], b[i])
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps([{k: v for k, v in r.items() if k != "narration_id"}
                                  for r in rows]))
    with pytest.raises(KeyError, match="narration_id"):
        read_annotations(str(bad), index_key="narration_id")


def test_an_hdf5_archive_points_at_the_roadmap(epic_root):
    """The fixture's ``EPIC_audio.hdf5`` (h5py's int16 datasets) gives the
    wav directory's items, bit for bit, in every split and both dtypes: the
    port reads the archive itself (``data/hdf5.py``) where it once refused
    it and pointed at the roadmap's exporter."""
    for int16, train_list in ((True, "train"), (True, "aug"), (False, "train")):
        for split in ("train", "val", "test", "train+val"):
            _, wav_cfg = epic_cfgs(epic_root, train_list, int16)
            _, h5_cfg = epic_cfgs(epic_root, train_list, int16, source="archive")
            wav, h5 = EpicKitchens(wav_cfg, split), EpicKitchens(h5_cfg, split)
            assert type(h5.audio).__name__ == "ArchiveAudio"
            assert len(h5) == len(wav) and h5.int16 == wav.int16
            for i in range(len(wav)):
                _assert_items_equal(h5[i], wav[i])


def _batches(ld):
    return [(b["index"], b["waveform"], b["n_valid"], b["labels"]["verb"], b["labels"]["noun"],
             np.asarray(b["metadata"]["narration_id"])) for b in ld]


@pytest.mark.parametrize("split,train_list,workers", [
    ("train", "aug", 0), ("train", "aug", 2), ("val", "train", 0), ("val", "train", 2),
    ("train+val", "train", 0),
])
def test_loader_matches_jax_order(epic_root, split, train_list, workers):
    """16 train rows in batches of 4 (drop_last: 4 batches), 10 val (4, 4,
    2), 26 train+val (6), over two epochs, with the narration ids."""
    jcfg, pcfg = epic_cfgs(epic_root, train_list)
    pcfg.DATA_LOADER.NUM_WORKERS = workers
    jl, pl = jax_loader.construct_loader(jcfg, split), loader.construct_loader(pcfg, split)
    try:
        assert len(pl) == len(jl) == {"train": 4, "val": 3, "train+val": 6}[split]
        for epoch in (0, 1):
            loader.shuffle_dataset(pl, epoch)
            jax_loader.shuffle_dataset(jl, epoch)
            got, want = _batches(pl), _batches(jl)
            assert len(got) == len(want) == len(pl)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        assert got[0][1].dtype == (np.float32 if train_list == "aug" else np.int16)
    finally:
        pl.close()
        jl.close()


# -- the multi-task head ---------------------------------------------------------

def _tiny_model_cfgs():
    jcfg, pcfg = _model_cfg(jax_get_cfg(), True), _model_cfg(get_cfg(), False)
    for cfg in (jcfg, pcfg):
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    return jcfg, pcfg


@pytest.fixture(scope="module")
def head_setup():
    rng = np.random.default_rng(1)
    slow = (rng.standard_normal((3, 16, 32, 1)) * 0.5).astype(np.float32)
    fast = (rng.standard_normal((3, 64, 32, 1)) * 0.5).astype(np.float32)
    jcfg, _ = _tiny_model_cfgs()
    model = jax_build_model(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xs: model.init(k, xs, train=False))(
        jax.random.PRNGKey(2), [jnp.asarray(slow), jnp.asarray(fast)]))
    paths = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in (slow, fast)]
    return variables, [slow, fast], paths


def _port_model(dtype, variables):
    _, pcfg = _tiny_model_cfgs()
    pcfg.GPU.COMPUTE_DTYPE = dtype
    model = build_model(pcfg, "cpu")
    model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    return model


@pytest.mark.parametrize("dtype,train_mode", [("float32", False), ("float32", True),
                                              ("bfloat16", False)])
def test_multitask_head_matches_flax(head_setup, dtype, train_mode):
    """Verb and noun outputs of the whole tiny model on the same weights:
    probabilities in eval mode (2e-5 in float32, 2e-2 in bf16), logits in
    train mode (1e-4)."""
    variables, xs, paths = head_setup
    jcfg, _ = _tiny_model_cfgs()
    jcfg.TPU.COMPUTE_DTYPE = dtype
    jmodel = jax_build_model(jcfg)
    if train_mode:
        want, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, xs)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, xs)
    model = _port_model(dtype, variables).train(train_mode)
    assert {"head.projection_verb.weight", "head.projection_noun.bias"} <= set(model.state_dict())
    # oneDNN's bf16 CPU convolution is wrong at this model's narrow s5
    # (test_torch_port_model.py::test_bf16_compute_probabilities_match)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = model(paths)
    tol = 2e-2 if dtype == "bfloat16" else (1e-4 if train_mode else 2e-5)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w, n in zip(got, want, CLASSES):
        assert g.shape == (3, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=tol, atol=tol)
    if not train_mode:
        for g in got:
            np.testing.assert_allclose(g.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_head_class_lists():
    """A one-element list is one task; a third element with
    ``ONLY_ACTION_RECOGNITION`` off is the state head's attributes."""
    _, pcfg = _tiny_model_cfgs()
    pcfg.MODEL.NUM_CLASSES = [6]
    assert "head.projection.weight" in build_model(pcfg, "cpu").state_dict()
    pcfg.MODEL.NUM_CLASSES = [6, 8, 5]
    pcfg.MODEL.ONLY_ACTION_RECOGNITION = False
    sd = build_model(pcfg, "cpu").state_dict()
    for name, rows in (("verb", 6), ("noun", 8), ("min_1", 5), ("0", 5), ("1", 5)):
        assert sd[f"head.projection_{name}.weight"].shape[0] == rows, name


# -- meters ----------------------------------------------------------------------

def test_epic_meters_log_the_jax_records():
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.LOG_PERIOD = 2
        cfg.SOLVER.MAX_EPOCH = 3
    rng = np.random.default_rng(0)

    def accs():
        return tuple(float(x) for x in rng.uniform(0, 100, 3))

    updates = [(accs(), accs(), {"loss": float(rng.uniform(0, 6)), "verb_loss": 1.5,
                                 "noun_loss": float(rng.uniform(0, 6)), "grad_norm": 3.0},
                float(rng.uniform(0, 0.1)), int(rng.integers(2, 9))) for _ in range(5)]
    vals = [[(accs(), accs(), int(rng.integers(2, 9))) for _ in range(3)] for _ in range(3)]
    vals[2] = vals[1]  # epoch 3 ties epoch 2's action top-1: not best
    out = {}
    for name, mod, cfg in (("asf_tpu", jax_meters, jcfg), ("asf_tpu_torch", meters, pcfg)):
        with captured(name) as log:
            train_m, val_m = mod.EPICTrainMeter(5, cfg), mod.EPICValMeter(3, cfg)
            bests = []
            for epoch in range(3):
                train_m.iter_tic()
                for it, (top1, top5, losses, lr, rows) in enumerate(updates):
                    train_m.data_toc()
                    train_m.update_stats(top1, top5, losses, lr, rows)
                    train_m.log_iter_stats(epoch, it)
                    train_m.iter_toc()
                    train_m.iter_tic()
                train_m.log_epoch_stats(epoch)
                train_m.reset()
                for it, (top1, top5, rows) in enumerate(vals[epoch]):
                    val_m.update_stats(top1, top5, rows)
                    val_m.log_iter_stats(epoch, it)
                bests.append(val_m.log_epoch_stats(epoch))
                val_m.reset()
        out[name] = (_untimed(log.stats), bests)
    (want, want_best), (got, got_best) = out["asf_tpu"], out["asf_tpu_torch"]
    assert len(got) == len(want) == 3 * (2 + 1 + 1 + 1)
    assert got == want
    assert got_best == want_best and [b for b, _ in got_best][2] is False
    assert {"verb_loss", "action_top5_acc"} <= set(got[0])


@pytest.mark.parametrize("method", ["sum", "max"])
def test_epic_test_meter_ensembles_as_jax(method):
    rng = np.random.default_rng(5)
    n, views = 5, 3
    verb_l, noun_l = rng.integers(0, 6, n), rng.integers(0, 8, n)
    batches = []  # the views in a shuffled order, in 4 ragged batches
    for chunk in np.array_split(rng.permutation(n * views), 4):
        clips = chunk // views
        batches.append(((rng.random((len(chunk), 6)), rng.random((len(chunk), 8))),
                        (verb_l[clips], noun_l[clips]),
                        {"narration_id": [f"n{c}" for c in clips]}, chunk))
    out = {}
    for name, mod in (("asf_tpu", jax_meters), ("asf_tpu_torch", meters)):
        m = mod.EPICTestMeter(n, views, CLASSES, 4, ensemble_method=method)
        for batch in batches:
            m.update_stats(*batch)
        with captured(name) as log:
            out[name] = (m.finalize_metrics(), log.stats)
    ((gp, gl, gm), gstats), ((wp, wl, wm), wstats) = out["asf_tpu_torch"], out["asf_tpu"]
    for g, w in zip(gp + gl, wp + wl):
        np.testing.assert_array_equal(g, w)
    assert list(gm) == list(wm) == [f"n{c}" for c in range(n)]
    assert [r for r in gstats if r["_type"] == "test_final"] == wstats


# -- the fine-tune load ----------------------------------------------------------

@pytest.mark.parametrize("classes", [[7], list(CLASSES)])
def test_a_port_checkpoint_of_other_heads_seeds_the_trunk(tmp_path, classes):
    """The failing case before the repair: ``TRAIN.CHECKPOINT_FILE_PATH``
    naming a port ``.pyth`` of a 9-class head loaded strictly, so it could
    seed no model with other heads (``load_state_dict`` raised on the
    head). Now the trunk equals the checkpoint leaf for leaf, each head
    leaf keeps its seeded value with a warning, and the optimizer, step and
    generator are not restored; ``CHECKPOINT_EPOCH_RESET`` starts at epoch 0."""
    _, src_cfg = _tiny_model_cfgs()
    src_cfg.MODEL.NUM_CLASSES = [9]
    src = init_state(src_cfg, build_model(src_cfg, "cpu", torch.Generator().manual_seed(3)))
    src.step = 11
    path = cu.save_checkpoint(str(tmp_path / "vgg"), src, 4, src_cfg)
    trunk = {k: v for k, v in src.model.state_dict().items() if not k.startswith("head.")}

    _, cfg = _tiny_model_cfgs()
    cfg.MODEL.NUM_CLASSES = classes
    cfg.OUTPUT_DIR = str(tmp_path / "epic")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = path
    for reset in (False, True):
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = reset
        model = build_model(cfg, "cpu", torch.Generator().manual_seed(5))
        head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("head.")}
        state = init_state(cfg, model)
        with captured("asf_tpu_torch") as log:
            start = cu.load_train_checkpoint(cfg, state)
        assert start == (0 if reset else 5) and state.step == 0
        assert not state.optimizer.state  # no momentum from the 9-class run
        got = model.state_dict()
        for k, v in trunk.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), k
        for k, v in head.items():
            assert torch.equal(got[k], v), k
        # [7]: the kernel and bias of another shape; [6, 8]: the two missing projections
        assert len(log.warnings) == 2 and all("head.projection" in w for w in log.warnings)


def test_a_whole_port_checkpoint_restores_its_train_state_and_auto_resume_stays_strict(tmp_path):
    _, cfg = _tiny_model_cfgs()
    src = init_state(cfg, build_model(cfg, "cpu", torch.Generator().manual_seed(3)))
    src.model(
        [torch.zeros(2, 1, 16, 32), torch.zeros(2, 1, 64, 32)])[0].sum().backward()
    src.optimizer.step()
    src.step = 11
    path = cu.save_checkpoint(str(tmp_path / "a"), src, 4, cfg)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = path
    cfg.OUTPUT_DIR = str(tmp_path / "b")
    state = init_state(cfg, build_model(cfg, "cpu"))
    with captured("asf_tpu_torch") as log:
        assert cu.load_train_checkpoint(cfg, state) == 5
    assert not log.warnings and state.step == 11 and state.optimizer.state
    for k, v in src.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state.model.state_dict()[k], v), k

    cfg.MODEL.NUM_CLASSES = [9]  # a checkpoint of other heads in OUTPUT_DIR
    os.makedirs(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
    os.replace(path, cu.get_path_to_checkpoint(cfg.OUTPUT_DIR, 5))
    other = init_state(cfg, build_model(cfg, "cpu"))
    with pytest.raises(RuntimeError, match="head.projection"):
        cu.load_train_checkpoint(cfg, other)


# -- train(cfg), test(cfg) and run_net ----------------------------------------------

def _loop_cfgs(root, out, train_list="aug"):
    """(JAX cfg, port cfg): the tiny verb/noun model on the EPIC set, one
    epoch of 4 steps (B = 4), precise BN over 2 batches, val in 4, 4, 2;
    BN frozen, as the EPIC configs have it (``entry.epic_cfg``)."""
    jcfg, pcfg = epic_cfgs(root, train_list)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.BN.FREEZE = True
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


@pytest.fixture(scope="module")
def start_pyth(tmp_path_factory):
    _, cfg = _tiny_model_cfgs()
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(5)).state_dict()
    path = str(tmp_path_factory.mktemp("start") / "start.pyth")
    torch.save({"model_state": sd, "epoch": 9}, path)
    return path


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


def test_train_matches_jax_train(epic_root, start_pyth, tmp_path, jitted_jax_init):
    """One epoch on the transformed train list (float32 waveforms) from the
    same start, then val: every leaf within 1e-4 relative L2, the epoch
    losses and the val accuracies equal to 4 decimals."""
    jcfg, pcfg = _loop_cfgs(epic_root, str(tmp_path))
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.CHECKPOINT_FILE_PATH = start_pyth
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    with pytest.MonkeyPatch.context() as mp, captured("asf_tpu") as jlog:
        mp.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
        jax_train(jcfg)
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 4
    with captured("asf_tpu_torch") as plog:
        state = train(pcfg, device="cpu")
    assert state.step == 4

    want = flax_variables_to_torch_state(jax.tree.map(np.asarray, payload["model_state"]))
    got = state.model.state_dict()
    assert set(got) == set(want)
    worst = {k: _rel_l2(got[k], w) for k, w in want.items()
             if not k.endswith("num_batches_tracked")}
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])

    (jep,), (pep,) = _records(jlog.stats, "train_epoch"), _records(plog.stats, "train_epoch")
    for k in ("loss", "verb_loss", "noun_loss", "action_top1_acc", "verb_top5_acc"):
        assert round(pep[k], 4) == round(jep[k], 4), (k, pep[k], jep[k])
    (jval,), (pval,) = _records(jlog.stats, "val_epoch"), _records(plog.stats, "val_epoch")
    assert set(pval) == set(jval)
    for k in jval:
        if k.endswith("_acc"):
            assert round(pval[k], 4) == round(jval[k], 4), (k, pval[k], jval[k])
    for kind, n in (("train_iter", 4), ("val_iter", 3)):
        assert len(_records(plog.stats, kind)) == len(_records(jlog.stats, kind)) == n
    names = os.listdir(os.path.join(pcfg.OUTPUT_DIR, "checkpoints"))
    assert "checkpoint_epoch_00001.pyth" in names
    assert ("checkpoint_best.pyth" in names) == (pval["action_top1_acc"] > 0)


def _grads(model, paths, labels, loss_fn):
    loss_fn(model(paths), labels)[0].backward()
    return {k: p.grad.double() for k, p in model.named_parameters()}


def test_unfrozen_bn_gradients_match_float64_on_a_silent_record(epic_root):
    """BN in train mode on a batch that holds a record with no samples and a
    short one (the silent frames are log(1e-6) everywhere): the port's
    float32 gradients, leaf by leaf, against the same model's in float64,
    within 1e-4 of each leaf's norm plus 1e-6 of the whole. The JAX
    package's float32 gradients on the same batch are printed beside: some
    of its leaves fall outside that bound. Its BN takes the variance in one
    pass, E[x^2] - E[x]^2 (``asf_tpu/models/norm.py:97-100``), which loses
    digits where a channel's mean dwarfs its spread; the port's takes it
    from the centred values. With BN unfrozen, a train(cfg) of 4 steps on
    this set therefore parts from the JAX one by more than float32 order
    in the small BN biases; ``test_train_matches_jax_train`` runs with BN
    frozen, as the EPIC configs do."""
    import copy

    from asf_tpu.engine.steps import make_loss_fn as jax_loss_fn
    from asf_tpu_torch.checkpoint.pyth_names import torch_state_to_flax
    from asf_tpu_torch.engine.pipeline import make_input_pipeline
    from asf_tpu_torch.engine.steps import make_loss_fn

    jcfg, pcfg = _loop_cfgs(epic_root, "", train_list="train")
    pcfg.BN.FREEZE = jcfg.BN.FREEZE = False
    batch = next(iter(loader.construct_loader(pcfg, "train")))
    assert 0 in batch["n_valid"] and (batch["n_valid"] < 2559).sum() >= 2
    wave, n_valid = batch["waveform"], batch["n_valid"]
    labels = {k: torch.from_numpy(v) for k, v in batch["labels"].items()}
    model = build_model(pcfg, "cpu", torch.Generator().manual_seed(5)).train()
    variables = jax.tree.map(jnp.asarray, {k: v for k, v in torch_state_to_flax(
        model.state_dict()).items() if k in ("params", "batch_stats")})
    paths = make_input_pipeline(pcfg, "cpu")(torch.from_numpy(wave), torch.from_numpy(n_valid))
    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    loss_fn = make_loss_fn(pcfg)
    g32 = _grads(model, paths, labels, loss_fn)
    g64 = _grads(m64, [p.double() for p in paths], labels, loss_fn)

    jmodel, jloss = jax_build_model(jcfg), jax_loss_fn(jcfg)
    jpaths = [jnp.asarray(p.permute(0, 2, 3, 1).numpy()) for p in paths]

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jpaths, train=True, mutable=["batch_stats"])
        return jloss(out, {k: jnp.asarray(v.numpy()) for k, v in labels.items()})[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
        jg = jax.jit(jax.grad(loss))(variables["params"])
    gj = flax_variables_to_torch_state({"params": jax.tree.map(np.asarray, jg)})
    scale = torch.cat([g.ravel() for g in g64.values()]).norm()
    outside = {"port": [], "jax": []}
    for k, g in g64.items():
        bound = 1e-4 * g.norm() + 1e-6 * scale
        for side, got in (("port", g32[k]), ("jax", gj[k].double())):
            if (got - g).norm() > bound:
                outside[side].append(k)
    print(f"leaves of {len(g64)} outside 1e-4 of the leaf + 1e-6 of the whole from float64: "
          f"port {len(outside['port'])}, asf_tpu {len(outside['jax'])} {outside['jax']}")
    assert not outside["port"], outside["port"]


def test_train_plus_val_trains_on_both_lists(epic_root, tmp_path):
    _, pcfg = _loop_cfgs(epic_root, str(tmp_path), train_list="train")
    pcfg.EPICKITCHENS.TRAIN_PLUS_VAL = True
    pcfg.BN.USE_PRECISE_STATS = False
    pcfg.TRAIN.EVAL_PERIOD = 5  # the last epoch still validates
    with captured("asf_tpu_torch") as log:
        state = train(pcfg, device="cpu")
    assert state.step == 26 // 4
    assert [r["iter"] for r in _records(log.stats, "train_iter")][-1] == "6/6"
    assert len(_records(log.stats, "val_epoch")) == 1


@pytest.fixture(scope="module")
def test_pyth(tmp_path_factory):
    """The JAX model's initial parameters with BN statistics drawn from a
    seed, through the port's converter."""
    jcfg, _ = _tiny_model_cfgs()
    model = jax_build_model(jcfg)
    s = int(round(SR * CLIP_SECS)) - 1
    jcfg.AUDIO_DATA.SAMPLING_RATE = SR
    jcfg.AUDIO_DATA.CLIP_SECS = CLIP_SECS
    paths = jax_pipeline(jcfg)(jnp.zeros((2, s), jnp.float32), jnp.full((2,), s, jnp.int32), None)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, xs: model.init(k, xs, train=False))(jax.random.PRNGKey(3), paths))
    rng = np.random.default_rng(4)

    def stat(path, v):
        if path[-1].key == "mean":
            return (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    path = str(tmp_path_factory.mktemp("weights") / "test.pyth")
    torch.save({"model_state": flax_variables_to_torch_state(variables), "epoch": 3}, path)
    return path


def _scores(cfg):
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
        return pickle.load(f)


def test_test_matches_jax_test(epic_root, test_pyth, tmp_path, jitted_jax_init):
    """6 test rows in 3 views, B = 4 (the last batch ragged): verb and noun
    scores within 1e-5, labels, narration ids and the pickle's keys equal."""
    jcfg, pcfg = _loop_cfgs(epic_root, str(tmp_path))
    for cfg in (jcfg, pcfg):
        cfg.TEST.CHECKPOINT_FILE_PATH = test_pyth
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    with captured("asf_tpu") as jlog:
        (jv, jn), (jvl, jnl), jids = jax_test(jcfg)
    with captured("asf_tpu_torch") as plog:
        (pv, pn), (pvl, pnl), pids = port_test(pcfg, device="cpu")
    assert pv.shape == jv.shape == (6, 6) and pn.shape == jn.shape == (6, 8)
    assert pv.dtype == pn.dtype == np.float64
    assert max(np.abs(pv - jv).max(), np.abs(pn - jn).max()) <= SCORE_TOL
    np.testing.assert_allclose(pv.sum(axis=1), VIEWS, atol=1e-5)
    for g, w in ((pvl, jvl), (pnl, jnl)):
        np.testing.assert_array_equal(g, w)
    assert list(pids) == list(jids) == [f"P01_{40 + r:03d}" for r in range(6)]
    (jfinal,) = _records(jlog.stats, "test_final")
    (pfinal,) = _records(plog.stats, "test_final")
    assert pfinal == jfinal
    got, want = _scores(pcfg), _scores(jcfg)
    assert got.keys() == want.keys() == {"verb_output", "noun_output", "labels", "narration_id"}
    assert got["labels"].keys() == want["labels"].keys() == {"verb", "noun"}
    np.testing.assert_array_equal(got["verb_output"], pv)
    assert list(got["narration_id"]) == list(want["narration_id"])


def test_run_net_trains_then_tests_epic(epic_root, tmp_path):
    """One epoch, then the test rows in 3 views from the epoch's checkpoint,
    from a YAML file written by ``cfg.dump()``."""
    _, cfg = _loop_cfgs(epic_root, str(tmp_path), train_list="train")
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    path = tmp_path / "run.yaml"
    path.write_text(cfg.dump())
    with captured("asf_tpu_torch") as log:
        run_net.main(["--cfg", str(path), "--device", "cpu", "TEST.SAVE_RESULTS_PATH", "cli.pkl"])
    kinds = [r["_type"] for r in log.stats]
    assert kinds.index("train_epoch") < kinds.index("test_final")
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "cli.pkl"), "rb") as f:
        scores = pickle.load(f)
    assert scores["verb_output"].shape == (6, 6) and scores["noun_output"].shape == (6, 8)
    assert np.isfinite(scores["noun_output"]).all() and len(scores["narration_id"]) == 6
