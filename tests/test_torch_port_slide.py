"""Sliding-window testing over untrimmed EPIC videos: the port against the JAX package.

The audio of ``test_torch_port_epic.py``'s set (3 videos of 6 s at 8 kHz:
the JAX package reads the HDF5 archive, the port wav files of the same
samples) with annotations of its own, a DataFrame indexed by
``narration_id`` for the JAX package and the same rows as a list of dicts
for the port, in no sorted order: up to 6 actions overlap one window, two
share a start, one stops before it starts, one runs past its video's end.
The video-durations csv lists the videos in another order, one video with
no annotation and one without audio; one duration ends before the audio
does. The clip is 0.32 s, so whole-video windows of 0.25 s are shorter than
a clip (as the repo's 1 s windows are shorter than its 1.999 s clip) and
windows of 0.5 s longer. Held to ``asf_tpu``: each mode's windows, labels,
ids and items bit for bit, ``SINGLE_BATCH``, the refusals, the loader with
2 worker processes, the slide metrics and ``EPICTestMeterSlide``,
``test(cfg)`` (the tiny SlowFast of ``test_torch_port_epic.py``, float32;
the JAX package's state made once for the module) within 1e-5 in each mode,
whole-video windows shorter and longer than the clip; then ``run_net`` on a
repo slide YAML.
"""

import os
import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from asf_tpu.data import loader as jax_loader
from asf_tpu.data.epickitchens_slide import EpicKitchensSlide as JaxSlide
from asf_tpu.engine import meters as jax_meters
from asf_tpu.engine import metrics as jax_metrics
from asf_tpu.engine import test_loop as jax_test_loop
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import loader
from asf_tpu_torch.data.epickitchens_slide import EpicKitchensSlide
from asf_tpu_torch.engine import meters, metrics
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.entry import SLIDE_MODES, epic_slide_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.tools import run_net
from asf_tpu_torch.utils.parser import load_config, parse_args
from test_torch_port_epic import CLASSES, SR, VIDEO_SECS, _ts, epic_cfgs, epic_root  # noqa: F401
from test_torch_port_loop import _model_cfg, captured
from test_torch_port_state import _jitted_init_state

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-5
# (WIN_SIZE, HOP_SIZE, INSIDE_ACTION_BOUNDS, PER_ACTION_INSTANCE)
MODES = {
    "whole_video": (0.25, 0.125, False, False),  # windows shorter than the 0.32 s clip
    "whole_video_long": (0.5, 0.25, False, False),  # longer
    "action_bounds": (0.5, 0.125, True, False),
    "per_instance": (0.5, 0.125, True, True),
}
# (video, start s, stop s): in no sorted order
ACTIONS = [
    ("P01_02", 1.00, 2.50), ("P01_00", 0.10, 2.90), ("P01_02", 0.40, 1.60),
    ("P01_02", 3.00, 3.20), ("P01_02", 0.40, 1.10), ("P01_02", 0.90, 1.30),
    ("P01_02", 4.00, 3.90), ("P01_02", 0.95, 1.20), ("P01_00", 2.00, 2.10),
    ("P01_02", 5.50, 6.40), ("P01_02", 1.05, 1.15),
]
# (video, duration s) in the csv's order: P01_01 has no annotation, P01_09
# no audio; P01_02 ends at 5.7 s, before its audio does.
DURATIONS = [("P01_02", 5.7), ("P01_01", VIDEO_SECS), ("P01_09", 3.0), ("P01_00", VIDEO_SECS)]


@pytest.fixture(scope="module")
def slide_root(epic_root, tmp_path_factory):  # noqa: F811
    """``slide.pkl`` (a DataFrame), ``slide_list.pkl`` (its rows as dicts)
    and ``video_info.csv`` beside ``epic_root``'s audio."""
    root = tmp_path_factory.mktemp("slide")
    rows = [{"narration_id": f"S_{i:03d}", "participant_id": "P01", "video_id": v,
             "start_timestamp": _ts(a), "stop_timestamp": _ts(b),
             "verb_class": i % CLASSES[0], "noun_class": (3 * i + 1) % CLASSES[1]}
            for i, (v, a, b) in enumerate(ACTIONS)]
    with open(root / "slide_list.pkl", "wb") as f:
        pickle.dump(rows, f)
    pd.DataFrame([{k: v for k, v in r.items() if k != "narration_id"} for r in rows],
                 index=[r["narration_id"] for r in rows]).to_pickle(root / "slide.pkl")
    pd.DataFrame(DURATIONS, columns=["video_id", "duration"]).to_csv(root / "video_info.csv",
                                                                     index=False)
    return epic_root, str(root)


def slide_cfgs(roots, mode, int16=True, batch=8):
    """(JAX cfg, port cfg) testing ``EpicKitchensSlide`` in ``mode``."""
    audio_root, root = roots
    jcfg, pcfg = epic_cfgs(audio_root, int16=int16, batch=batch)
    win, hop, inside, per = MODES[mode]
    for cfg, suffix in ((jcfg, ""), (pcfg, "_list")):
        cfg.TEST.DATASET = "EpicKitchensSlide"
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 1
        cfg.EPICKITCHENS.ANNOTATIONS_DIR = root
        cfg.EPICKITCHENS.PROCESSED_TEST_LIST = f"slide{suffix}.pkl"
        cfg.EPICKITCHENS.VIDEO_DURS = "video_info.csv"
        s = cfg.TEST.SLIDE
        s.ENABLE = True
        s.WIN_SIZE, s.HOP_SIZE = win, hop
        s.INSIDE_ACTION_BOUNDS, s.PER_ACTION_INSTANCE = inside, per
    return jcfg, pcfg


def _assert_items_equal(got, want):
    assert got["waveform"].dtype == want["waveform"].dtype
    np.testing.assert_array_equal(got["waveform"], want["waveform"])
    assert got["n_valid"] == want["n_valid"] and got["n_valid"].dtype == np.int32
    assert got["label"].keys() == want["label"].keys() == {"verb", "noun"}
    for k in ("verb", "noun"):
        np.testing.assert_array_equal(got["label"][k], want["label"][k])
    assert got["index"] == want["index"]
    assert got["metadata"] == want["metadata"]


def _whole_video_windows(win, hop):
    """Windows a kept video gives: while the middle lies before its end."""
    count = {}
    for video, duration in DURATIONS:
        if not any(v == video for v, _, _ in ACTIONS):
            continue
        n, start, end = 0, 0.0, win
        while (start + end) / 2 < duration:
            n += 1
            start += hop
            end = start + win
        count[video] = n
    return count


@pytest.mark.parametrize("mode,int16", [(m, True) for m in MODES] + [("whole_video", False)])
def test_windows_match_jax(slide_root, mode, int16):
    jcfg, pcfg = slide_cfgs(slide_root, mode, int16)
    jds, pds = JaxSlide(jcfg, "test"), EpicKitchensSlide(pcfg, "test")
    assert len(pds) == len(jds._audio_records) == len(jds)
    assert pds.int16 == jds.int16 == int16
    for i, rec in enumerate(jds._audio_records):
        assert (pds._start[i], pds._start[i] + pds._num[i]) == (
            rec.start_audio_sample, rec.end_audio_sample), i
        _assert_items_equal(pds[i], jds[i])
    order = np.random.default_rng(1).permutation(len(pds))
    for i, item in zip(order, pds.get_batch(0, order)):
        _assert_items_equal(item, jds[i])
    verbs = pds._labels["verb"]
    ids = pds._narration
    if mode.startswith("whole_video"):
        counts = _whole_video_windows(*MODES[mode][:2])
        assert len(pds) == sum(counts.values())
        assert verbs.shape == pds._labels["noun"].shape == (len(pds), 4)
        # every window of a video shares its row number among the csv rows kept
        assert ids == ["0"] * counts["P01_02"] + ["1"] * counts["P01_00"]
        annotated = verbs[:, 0] != -1
        assert annotated.any() and (~annotated).any()
        assert (verbs[~annotated] == -1).all()
        # the unused slots repeat the first label; up to 4 are kept where 6 overlap
        distinct = [len(set(row)) for row in verbs[annotated].tolist()]
        assert min(distinct) == 1 and max(distinct) == 4
        assert (verbs[annotated][np.asarray(distinct) == 1] == verbs[annotated][
            np.asarray(distinct) == 1][:, :1]).all()
        n_valid = [int(pds[i]["n_valid"]) for i in range(len(pds))]
        assert (max(n_valid) < pds.clip_samples) == (mode == "whole_video")
    else:
        assert verbs.shape == (len(pds),)
        assert set(ids) == {f"S_{i:03d}" for i in range(len(ACTIONS))}
        assert (len(pds) > len(ACTIONS)) == (mode == "action_bounds")


@pytest.mark.parametrize("mode,want", [("whole_video", 5), ("action_bounds", 5)])
def test_single_batch_keeps_the_first_windows_or_rows(slide_root, mode, want):
    """``TEST.BATCH_SIZE`` windows in whole-video mode; in action-bounds
    mode the windows of the first ``TEST.BATCH_SIZE`` rows."""
    jcfg, pcfg = slide_cfgs(slide_root, mode, batch=5)
    for cfg in (jcfg, pcfg):
        cfg.EPICKITCHENS.SINGLE_BATCH = True
    jds, pds = JaxSlide(jcfg, "test"), EpicKitchensSlide(pcfg, "test")
    assert len(pds) == len(jds)
    assert (len(pds) == want) == (mode == "whole_video")
    assert set(pds._narration) <= ({"0"} if mode == "whole_video"
                                   else {f"S_{i:03d}" for i in range(5)})
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])


def test_other_splits_and_per_instance_alone_are_refused(slide_root):
    jcfg, pcfg = slide_cfgs(slide_root, "whole_video")
    for split in ("train", "val", "train+val"):
        with pytest.raises(AssertionError):
            JaxSlide(jcfg, split)
        with pytest.raises(ValueError, match="only tests"):
            EpicKitchensSlide(pcfg, split)
    for cfg in (jcfg, pcfg):
        cfg.TEST.SLIDE.INSIDE_ACTION_BOUNDS = False
        cfg.TEST.SLIDE.PER_ACTION_INSTANCE = True
    with pytest.raises(NotImplementedError):
        JaxSlide(jcfg, "test")
    with pytest.raises(NotImplementedError):
        EpicKitchensSlide(pcfg, "test")


def _batches(ld):
    return [(b["index"], b["waveform"], b["n_valid"], b["labels"]["verb"], b["labels"]["noun"],
             np.asarray(b["metadata"]["narration_id"])) for b in ld]


def test_the_loader_reads_the_windows_in_worker_processes(slide_root):
    """The windows in batches of 8 with their (8, 4) labels: 2 worker
    processes, each rebuilding the slide set from its config, read what the
    JAX loader reads."""
    jcfg, pcfg = slide_cfgs(slide_root, "whole_video")
    pcfg.DATA_LOADER.NUM_WORKERS = 2
    jl, pl = jax_loader.construct_loader(jcfg, "test"), loader.construct_loader(pcfg, "test")
    try:
        got, want = _batches(pl), _batches(jl)
        assert len(pl.worker_pids()) == 2
    finally:
        pl.close()
        jl.close()
    assert len(got) == len(want) == -(-len(pl.dataset) // 8)
    assert got[0][3].shape == (8, 4)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- metrics and meter ------------------------------------------------------------

def _slide_inputs(per_action_instance, weighted):
    """Scores on a coarse grid (ties in the top-k), labels with -1 slots."""
    rng = np.random.default_rng(5)
    preds = np.round(rng.uniform(0, 1, (40, 7)), 1)
    if per_action_instance:
        labels = rng.integers(0, 7, 40)
    else:
        labels = rng.integers(0, 7, (40, 4))
        labels[rng.uniform(size=(40, 4)) < 0.4] = -1
        labels[:, 0] = np.abs(labels[:, 0])
    weight = rng.integers(1, 4, 40).astype(np.float64) if weighted else None
    return preds, labels, weight


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("per_action_instance", [True, False])
def test_slide_metrics_match_jax(per_action_instance, weighted):
    preds, labels, weight = _slide_inputs(per_action_instance, weighted)
    preds2, labels2, _ = _slide_inputs(per_action_instance, False)
    labels2 = (labels2 + 3) % 7 if per_action_instance else np.where(
        labels2 >= 0, (labels2 + 3) % 7, -1)
    ks = (1, 3, 5)
    for name, args in (
            ("topks_correct_slide", (preds, labels, ks)),
            ("topk_accuracies_slide", (preds, labels, ks)),
            ("multitask_topks_correct_slide", ((preds, preds2[:, ::-1]), (labels, labels2), ks)),
            ("multitask_topk_accuracies_slide", ((preds, preds2[:, ::-1]), (labels, labels2), ks))):
        got = getattr(metrics, name)(*args, per_action_instance, weight)
        want = getattr(jax_metrics, name)(*args, per_action_instance, weight)
        assert len(got) == len(ks)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=name)


def test_slide_meter_matches_jax_on_the_meter_tests_cases():
    """``tests/test_meters.py``'s two cases: a window scored twice (its
    scores summed, each window weighted alike), per instance and in the
    whole-video case of (N, 4) labels with -1 windows left out."""
    rng = np.random.default_rng(0)
    vp, npp = rng.standard_normal((4, 8)), rng.standard_normal((4, 6))
    vl, nl = np.array([0, 1, 2, 0]), np.array([1, 0, 1, 1])
    meta = {"narration_id": ["P01_01_0", "P01_01_1", "P01_01_2", "P01_01_3"]}
    wl = np.array([[0, 3, 0, 0], [-1, -1, -1, -1], [2, 2, 2, 2], [5, 0, 1, 0]])
    for per_instance, (lv, ln) in ((True, (vl, nl)), (False, (wl, wl % 6))):
        out = {}
        for name, mod in (("asf_tpu", jax_meters), ("asf_tpu_torch", meters)):
            with captured(name) as log:
                m = mod.EPICTestMeterSlide(num_windows=4, num_cls=(8, 6),
                                           per_action_instance=per_instance)
                m.update_stats((vp, npp), (lv, ln), meta, np.arange(4))
                m.update_stats((vp[1:2], npp[1:2]), (lv[1:2], ln[1:2]),
                               {"narration_id": ["P01_01_1"]}, np.array([1]))
                result = m.finalize_metrics()
            out[name] = (result, m.verb_preds, log.stats)
        (jres, jsum, jstats), (pres, psum, pstats) = out["asf_tpu"], out["asf_tpu_torch"]
        np.testing.assert_allclose(psum[1], 2 * vp[1], rtol=0, atol=1e-12)
        np.testing.assert_allclose(psum, jsum, rtol=0, atol=1e-12)
        assert pstats == jstats and pstats[0]["num_windows_eval"] == (4 if per_instance else 3)
        for g, w in zip(pres[0] + pres[1], jres[0] + jres[1]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        assert list(pres[2]) == list(jres[2])


# -- test(cfg) and run_net --------------------------------------------------------

@pytest.fixture(scope="module")
def slide_pyth(tmp_path_factory):
    """The tiny verb/noun SlowFast's seeded weights with seeded BN statistics."""
    cfg = _model_cfg(get_cfg(), False)
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(6)).state_dict()
    g = torch.Generator().manual_seed(7)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0.0, 0.1, generator=g)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=g)
    path = str(tmp_path_factory.mktemp("weights") / "slide.pyth")
    torch.save({"model_state": sd, "epoch": 2}, path)
    return path


@pytest.fixture(scope="module")
def jax_state_once():
    """``asf_tpu``'s ``init_state`` (its model init jitted), made at the
    first call and handed to every later one: each test of this module
    builds the same model at the same batch shape, and the test checkpoint
    overwrites every leaf of it."""
    made = []

    def init_state(*args):
        if not made:
            made.append(_jitted_init_state(*args))
        return made[0]

    return init_state


def _scores(cfg):
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "slide.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_test_matches_jax_test(slide_root, slide_pyth, tmp_path, mode, jax_state_once,
                               monkeypatch):
    """Each window scored once at B = 16 (the last batch ragged): the scored
    windows' verb and noun scores within 1e-5, their labels, ids, the
    ``test_final`` record and the pickle's keys and shapes equal."""
    jcfg, pcfg = slide_cfgs(slide_root, mode, batch=16)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.OUTPUT_DIR = str(tmp_path / ("jax" if side else "port"))
        cfg.TEST.CHECKPOINT_FILE_PATH = slide_pyth
        cfg.TEST.SAVE_RESULTS_PATH = "slide.pkl"
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    monkeypatch.setattr(jax_test_loop, "init_state", jax_state_once)
    with captured("asf_tpu") as jlog:
        (jv, jn), (jvl, jnl), jids = jax_test(jcfg)
    with captured("asf_tpu_torch") as plog:
        (pv, pn), (pvl, pnl), pids = port_test(pcfg, device="cpu")
    assert pv.shape == jv.shape and pn.shape == jn.shape and pv.shape[1:] == (CLASSES[0],)
    assert 0 < pv.shape[0] <= len(EpicKitchensSlide(pcfg, "test"))
    assert max(np.abs(pv - jv).max(), np.abs(pn - jn).max()) <= SCORE_TOL
    np.testing.assert_allclose(pv.sum(axis=1), 1.0, atol=1e-5)
    for g, w in ((pvl, jvl), (pnl, jnl)):
        np.testing.assert_array_equal(g, w)
    # the meter keeps 4 label slots a window unless it tests per instance
    assert pvl.shape == ((pv.shape[0],) if mode == "per_instance" else (pv.shape[0], 4))
    assert list(pids) == list(jids)
    (jfinal,), (pfinal,) = ([r for r in log.stats if r["_type"] == "test_final"]
                            for log in (jlog, plog))
    assert pfinal == jfinal and pfinal["num_windows_eval"] == pv.shape[0]
    got, want = _scores(pcfg), _scores(jcfg)
    assert got.keys() == want.keys() == {"verb_output", "noun_output", "labels", "narration_id"}
    for k in ("verb_output", "noun_output"):
        assert got[k].shape == want[k].shape
    for k in ("verb", "noun"):
        assert got["labels"][k].shape == want["labels"][k].shape


@pytest.mark.parametrize("mode", sorted(SLIDE_MODES))
def test_epic_slide_cfg_takes_its_yaml_values(mode):
    name = {"whole_video": "asf-original-whole-video-1s.yaml",
            "action_bounds": "asf-original-action-bounds.yaml",
            "per_instance": "asf-original-per-instance.yaml"}[mode]
    want = load_config(parse_args(["--cfg", str(ROOT / "models/asf/config/slide" / name)]))
    got = epic_slide_cfg(mode)
    assert got.TEST.SLIDE == want.TEST.SLIDE
    for key in ("DATASET", "BATCH_SIZE", "NUM_ENSEMBLE_VIEWS"):
        assert got.TEST[key] == want.TEST[key], key
    assert not got.TRAIN.ENABLE and want.TRAIN.ENABLE  # the YAMLs only test all the same


def test_run_net_tests_a_repo_slide_yaml(slide_root, tmp_path):
    """``run_net --cfg models/asf/config/slide/asf-original-whole-video-1s.yaml``
    with ``TRAIN.ENABLE False``, the data paths and the tiny geometry as
    overrides, from a checkpoint of the model that config builds."""
    audio_root, root = slide_root
    yaml = str(ROOT / "models/asf/config/slide/asf-original-whole-video-1s.yaml")
    opts = ["TRAIN.ENABLE", "False", "OUTPUT_DIR", str(tmp_path / "out"),
            "EPICKITCHENS.AUDIO_DATA_FILE", os.path.join(audio_root, "audio"),
            "EPICKITCHENS.ANNOTATIONS_DIR", root,
            "EPICKITCHENS.PROCESSED_TEST_LIST", "slide_list.pkl",
            "EPICKITCHENS.VIDEO_DURS", "video_info.csv",
            "TEST.BATCH_SIZE", "16", "TEST.SAVE_RESULTS_PATH", "cli.pkl",
            "MODEL.NUM_CLASSES", str(list(CLASSES)), "RESNET.DEPTH", "26",
            "RESNET.WIDTH_PER_GROUP", "8", "AUDIO_DATA.SAMPLING_RATE", str(SR),
            "AUDIO_DATA.CLIP_SECS", "0.32", "AUDIO_DATA.N_FFT", "256",
            "AUDIO_DATA.NUM_FRAMES", "64", "AUDIO_DATA.NUM_FREQUENCIES", "32",
            "TEST.SLIDE.WIN_SIZE", "0.25", "TEST.SLIDE.HOP_SIZE", "0.125",
            "GPU.COMPUTE_DTYPE", "float32", "DATA_LOADER.NUM_WORKERS", "0"]
    cfg = load_config(parse_args(["--cfg", yaml, *opts]))
    path = str(tmp_path / "tiny.pyth")
    torch.save({"model_state": build_model(cfg, "cpu").state_dict()}, path)
    with captured("asf_tpu_torch") as log:
        run_net.main(["--cfg", yaml, "--device", "cpu", *opts,
                      "TEST.CHECKPOINT_FILE_PATH", path])
    assert not [r for r in log.stats if r["_type"].startswith("train")]
    (final,) = [r for r in log.stats if r["_type"] == "test_final"]
    with open(tmp_path / "out" / "scores" / "cli.pkl", "rb") as f:
        scores = pickle.load(f)
    n = final["num_windows_eval"]
    assert scores["verb_output"].shape == (n, CLASSES[0])
    assert scores["labels"]["verb"].shape == (n, 4)
    assert np.isfinite(scores["noun_output"]).all() and set(scores["narration_id"]) == {"0", "1"}
