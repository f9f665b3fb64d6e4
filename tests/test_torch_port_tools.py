"""The port's tools against the JAX package's: ``predict`` over whole files,
the spectrogram dumper's pathways, ``fix_weights``, ``stress_test``,
``extract_audio`` and the HDF5 <-> wav round trip.

``predict`` runs both packages' CLIs on the same wav files and the same
reference-named ``.pyth`` (the port's seeded weights through
``asf_tpu/checkpoint/pyth_converter.py``), the tiny depth-26 verb/noun
SlowFast of ``tests/test_torch_port_epic.py`` in float32 with the float32
front end: a whole file whose frame count is not a multiple of ALPHA, a
file shorter than a clip (its last frame repeated) and one at another
sample rate (resampled).
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import asf_tpu.models as jax_models

from asf_tpu.checkpoint.pyth_converter import flax_to_torch_state as jax_flax_to_torch_state
from asf_tpu.checkpoint.pyth_converter import torch_state_to_flax as jax_torch_state_to_flax
from asf_tpu.data.epickitchens import EpicKitchens as JaxEpicKitchens
from asf_tpu.data.epickitchens import EpicKitchensGRU as JaxEpicKitchensGRU
from asf_tpu.models import build_model as jax_build_model
from asf_tpu.tools import fix_weights as jax_fix_weights
from asf_tpu.tools import predict as jax_predict
from asf_tpu.visualization import spectrograms as jax_spectrograms
from asf_tpu_torch.data.epickitchens import EpicKitchens, EpicKitchensGRU
from asf_tpu_torch.models import build_model
from asf_tpu_torch.tools import extract_audio, fix_weights, hdf5_to_wav, predict, wav_to_hdf5
from asf_tpu_torch.tools.stress_test import stress_test
from asf_tpu_torch.visualization import spectrograms
from test_torch_port_epic import CLASSES, SR, _assert_items_equal, epic_cfgs, epic_root  # noqa
from test_torch_port_loop import _model_cfg

# predict's probabilities: the eval forward's float32 bound of
# tests/test_torch_port_model.py (the front ends' float32 difference, ~1e-7 of
# a log-mel value, moves them far less)
SCORE_TOL = 2e-5
# _item_pathways: the two float32 front ends on the same samples, log domain,
# max abs (tests/test_torch_port_logmel.py's bound)
SPEC_TOL = 1e-4


def _predict_cfgs(root, arch="slowfast"):
    jcfg, pcfg = (_model_cfg(cfg, side) for cfg, side in zip(epic_cfgs(root), (True, False)))
    for cfg in (jcfg, pcfg):
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.MODEL.ARCH = arch
        cfg.OUTPUT_DIR = os.path.join(root, "jax" if cfg is jcfg else "port")
    return jcfg, pcfg


@pytest.fixture(scope="module")
def predict_setup(tmp_path_factory):
    """The YAMLs of both packages, the reference-named ``.pyth`` and three wav files."""
    root = str(tmp_path_factory.mktemp("predict"))
    jcfg, pcfg = _predict_cfgs(root)
    sd = build_model(pcfg, "cpu", torch.Generator().manual_seed(11)).state_dict()
    ref = jax_flax_to_torch_state(jax_torch_state_to_flax({k: v.numpy() for k, v in sd.items()}))
    ckpt = os.path.join(root, "SLOWFAST_EPIC.pyth")
    torch.save({"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()},
                "epoch": 3}, ckpt)
    yamls = []
    for cfg in (jcfg, pcfg):
        cfg.TEST.CHECKPOINT_FILE_PATH = ckpt
        path = os.path.join(root, ("jax" if cfg is jcfg else "port") + ".yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        yamls.append(path)
    rng = np.random.default_rng(5)
    wavs = {}
    # 10,960 samples: 275 frames, 272 after the ALPHA rounding; 0.2 s: 41 frames
    # of 64; 21,920 samples at 16 kHz resampled to the long file's 10,960
    for name, rate, n in (("long", SR, 10960), ("short", SR, 1600), ("rate", 16000, 21920)):
        wavs[name] = os.path.join(root, f"{name}.wav")
        wavfile.write(wavs[name], rate, (rng.standard_normal(n) * 3000).astype(np.int16))
    return root, yamls, wavs, pcfg


class _Jitted:
    """A Flax model whose eval ``init`` and ``apply`` are jitted: the JAX
    predict's own calls, one compile each instead of op-by-op dispatch, and
    kept a config (``_JITTED``) so that a file of the same length reuses them."""

    def __init__(self, model):
        self._init = jax.jit(lambda key, xs: model.init(key, xs, train=False))
        self._apply = jax.jit(lambda v, xs: model.apply(v, xs, train=False))

    def init(self, key, xs, train=False):
        assert not train
        return self._init(key, xs)

    def apply(self, variables, xs, train=False):
        assert not train
        return self._apply(variables, xs)


_JITTED = {}


@pytest.mark.parametrize("case,frames", [("long", 272), ("short", 64), ("rate", 272)])
def test_predict_matches_jax(predict_setup, case, frames, monkeypatch):
    root, (jyaml, pyaml), wavs, _ = predict_setup
    monkeypatch.setattr(jax_models, "build_model", lambda cfg: _JITTED.setdefault(
        cfg.dump(), _Jitted(jax_build_model(cfg))))
    want = jax_predict.main([wavs[case], "--cfg", jyaml, "--labels-dir", root])
    got = predict.main([wavs[case], "--cfg", pyaml, "--device", "cpu", "--labels-dir", root])
    assert len(got) == len(want) == 2
    for g, w, n in zip(got, want, CLASSES):
        assert g.shape == np.asarray(w).shape == (1, n)
        np.testing.assert_allclose(g, np.asarray(w), rtol=SCORE_TOL, atol=SCORE_TOL)
    saved = np.load(os.path.join(root, "port", "predict_scores.npz"))
    assert sorted(saved.files) == ["noun", "verb"]
    np.testing.assert_array_equal(saved["verb"], got[0])
    assert os.path.exists(os.path.join(root, "port", "predict_scores.png"))
    _, pcfg = _predict_cfgs(root)
    paths = predict.load_audio(pcfg, wavs[case], "cpu")
    assert [p.shape[2] for p in paths] == [frames // pcfg.SLOWFAST.ALPHA, frames]


def test_predict_writes_scores_without_matplotlib(predict_setup, monkeypatch):
    root, (_, pyaml), wavs, _ = predict_setup
    png = os.path.join(root, "port", "predict_scores.png")
    if os.path.exists(png):
        os.remove(png)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    preds = predict.main([wavs["short"], "--cfg", pyaml, "--device", "cpu",
                          "OUTPUT_DIR", os.path.join(root, "port")])
    assert not os.path.exists(png)
    np.testing.assert_array_equal(
        np.load(os.path.join(root, "port", "predict_scores.npz"))["noun"], preds[1])


def test_predict_refuses_the_gru_model(predict_setup):
    _, (_, pyaml), wavs, _ = predict_setup
    with pytest.raises(SystemExit, match="single-clip"):
        predict.main([wavs["short"], "--cfg", pyaml, "--device", "cpu",
                      "MODEL.MODEL_NAME", "AudioSlowFastGRU"])


def test_predict_raises_without_cuda(predict_setup, monkeypatch):
    _, (_, pyaml), wavs, _ = predict_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([wavs["short"], "--cfg", pyaml])


@pytest.mark.parametrize("dataset", ["EpicKitchens", "EpicKitchensGRU"])
def test_item_pathways_match_jax(epic_root, tmp_path, dataset):  # noqa: F811
    """The dumper's pathways of one item through both input pipelines; the
    PNGs written."""
    jcfg, pcfg = epic_cfgs(epic_root)
    for cfg, side in ((jcfg, True), (pcfg, False)):
        _model_cfg(cfg, side)
    jcls, pcls = {"EpicKitchens": (JaxEpicKitchens, EpicKitchens),
                  "EpicKitchensGRU": (JaxEpicKitchensGRU, EpicKitchensGRU)}[dataset]
    jitem, pitem = jcls(jcfg, "train")[1], pcls(pcfg, "train")[1]
    got = spectrograms._item_pathways(pcfg, pitem, "cpu")
    want = jax_spectrograms._item_pathways(jcfg, jitem)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)[..., 0]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= SPEC_TOL
    files = spectrograms.plot_spectrograms(got, index=1, d_type="regular",
                                           output_root=str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["slow_1__regular.png", "fast_1__regular.png"]
    assert all(os.path.getsize(f) > 0 for f in files)


def test_fix_weights_round_trip_matches_jax(tmp_path):
    sd = {"s1.stem.conv.weight": torch.randn(4, 1, 1, 7),
          "module.head.projection.weight": torch.randn(6, 16)}
    for add, strip in (("model.", ""), ("", "module."), ("model.", "module.")):
        assert list(fix_weights.fix_state_keys(sd, add, strip)) == list(
            jax_fix_weights.fix_state_keys(sd, add, strip))
    src, mid, out = (str(tmp_path / n) for n in ("in.pyth", "mid.pyth", "out.pyth"))
    torch.save({"model_state": sd, "epoch": 3}, src)
    fix_weights.main([src, mid, "--add-prefix", "model."])
    ck = torch.load(mid, map_location="cpu", weights_only=False)
    assert list(ck["model_state"]) == ["model." + k for k in sd] and ck["epoch"] == 3
    fix_weights.main([mid, out, "--strip-prefix", "model."])
    back = torch.load(out, map_location="cpu", weights_only=False)["model_state"]
    assert list(back) == list(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_stress_test_reports_a_positive_rate():
    assert stress_test(n=256, seconds=0.2, chain=4, device="cpu") > 0.0


def test_extract_audio_discovers_and_maps_outputs(tmp_path, monkeypatch):
    vids = tmp_path / "videos"
    (vids / "P01").mkdir(parents=True)
    for name in ["P01/P01_01.MP4", "P01/P01_02.mp4", "P01/notes.txt"]:
        (vids / name).write_text("x")
    calls = []
    monkeypatch.setattr(extract_audio.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    extract_audio.main([str(vids), str(tmp_path / "wav"), "--sampling_rate", "24000",
                        "--jobs", "2"])
    assert sorted(os.path.basename(c[-1]) for c in calls) == ["P01_01.wav", "P01_02.wav"]
    assert all(c[0] == "ffmpeg" and c[c.index("-ar") + 1] == "24000" for c in calls)


@pytest.mark.parametrize("int16", [False, True])
def test_wav_to_hdf5_to_wav_round_trip(tmp_path, int16):
    """Mono int16 wav files -> the archive (float32 or raw int16) -> wav
    files with the same samples, bit for bit."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    rng = np.random.default_rng(4)
    waves = {f"P0{i}_01": (rng.standard_normal(3000 + 7 * i) * 9000).astype(np.int16)
             for i in range(3)}
    waves["P02_01"][:4] = [-32768, 32767, 0, -1]  # the extremes survive
    for name, wave in waves.items():
        wavfile.write(str(src / f"{name}.wav"), SR, wave)
    archive = str(tmp_path / "EPIC_audio.hdf5")
    wav_to_hdf5.main([str(src), archive, "--sampling_rate", str(SR), "--jobs", "2"]
                     + (["--int16"] if int16 else []))
    hdf5_to_wav.main([archive, str(dst), "--sampling_rate", str(SR)])
    assert sorted(os.listdir(dst)) == sorted(f"{n}.wav" for n in waves)
    for name, wave in waves.items():
        sr, back = wavfile.read(str(dst / f"{name}.wav"))
        assert sr == SR and back.dtype == np.int16
        np.testing.assert_array_equal(back, wave)


def test_exported_wavs_give_the_jax_items(epic_root, tmp_path):  # noqa: F811
    """The JAX package's archive exported to wav files: the port's items
    from them equal the JAX package's from the archive, bit for bit."""
    out = tmp_path / "exported"
    hdf5_to_wav.main([os.path.join(epic_root, "EPIC_audio.hdf5"), str(out),
                      "--sampling_rate", str(SR)])
    jcfg, pcfg = epic_cfgs(epic_root)
    pcfg.EPICKITCHENS.AUDIO_DATA_FILE = str(out)
    jds, pds = JaxEpicKitchens(jcfg, "train"), EpicKitchens(pcfg, "train")
    assert len(pds) == len(jds) == 16
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])
    with open(os.path.join(epic_root, "train_list.pkl"), "rb") as f:
        assert len(pickle.load(f)) == 16
