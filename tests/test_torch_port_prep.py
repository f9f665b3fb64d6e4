"""The port's dataset preparation and ``main`` against the JAX package's.

``prepare_dataset`` runs on ``tests/test_dataset_prep.py``'s fixture
(verb and noun csvs, original train and val lists as pickled DataFrames,
the repo's ``pddl/domain.pddl``) with the augmentation on, balanced and
unbalanced: the port's processed lists of dicts equal the JAX package's
DataFrames row for row, every column (``transformation`` draws, the
``precs``/``posts`` vectors, ``noun_embedding`` from the table the JAX run
wrote), and ``attributes.csv`` byte for byte. ``python -m
asf_tpu_torch.main`` prepares, trains and tests the tiny EPIC set of
``tests/test_torch_port_epic.py`` from list-of-dict originals, in a fresh
interpreter that loads none of the modules the card's machine lacks.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.state.dataset_prep import prepare_dataset as jax_prepare_dataset
from asf_tpu_torch import main as port_main
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data.transforms import get_transforms
from asf_tpu_torch.data.vggsound import read_annotations
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train as port_train
from asf_tpu_torch.state.dataset_prep import augment_data, prepare_dataset
from test_torch_port_epic import CLASSES, CLIP_SECS, SR, VIEWS, epic_root  # noqa: F401
from test_torch_port_loop import _model_cfg

ROOT = Path(__file__).resolve().parents[1]
DOMAIN_VERBS = ["break", "close", "cut", "dry", "fill", "open", "shake", "wash"]


def _fixture(root):
    """``tests/test_dataset_prep.py``'s inputs in ``root``."""
    pd.DataFrame({"id": range(10), "key": DOMAIN_VERBS + ["peel", "pour"]}).to_csv(
        os.path.join(root, "verbs.csv"), index=False)
    pd.DataFrame({"id": range(5), "key": ["pan", "cup", "tap", "lid", "egg"]}).to_csv(
        os.path.join(root, "nouns.csv"), index=False)
    rng = np.random.default_rng(0)
    rows = {"verb_class": rng.integers(0, 8, 40), "noun_class": rng.integers(0, 5, 40),
            "video_id": ["P01_01"] * 40}
    rows["verb_class"][:20] = 0  # skewed, so that the balancing has work
    pd.DataFrame(rows).to_pickle(os.path.join(root, "orig_train.pkl"))
    pd.DataFrame({k: v[:10] for k, v in rows.items()}).to_pickle(
        os.path.join(root, "orig_val.pkl"))


def _prep_cfg(cfg, root, tag, balance=True):
    ek = cfg.EPICKITCHENS
    ek.VERBS_FILE = os.path.join(root, "verbs.csv")
    ek.NOUNS_FILE = os.path.join(root, "nouns.csv")
    ek.ORIGINAL_TRAIN_LIST = os.path.join(root, "orig_train.pkl")
    ek.ORIGINAL_VAL_LIST = os.path.join(root, "orig_val.pkl")
    ek.PROCESSED_TRAIN_LIST = os.path.join(root, f"{tag}_train.pkl")
    ek.PROCESSED_VAL_LIST = os.path.join(root, f"{tag}_val.pkl")
    ek.STATE.PDDL_DOMAIN = str(ROOT / "pddl" / "domain.pddl")
    ek.STATE.PDDL_PROBLEM = str(ROOT / "pddl" / "problem.pddl")
    ek.STATE.NOUNS_EMBEDDINGS_FILE = os.path.join(root, "nouns_embeddings.pkl")
    ek.VERBS = DOMAIN_VERBS
    ek.ALL_VERBS = False
    ek.AUGMENT.ENABLE = True
    ek.AUGMENT.BALANCE = balance
    ek.AUGMENT.FACTOR = 1.0
    cfg.MODEL.PDDL_ATTRIBUTES = os.path.join(root, f"{tag}_attributes.csv")
    cfg.MODEL.ONLY_ACTION_RECOGNITION = False
    cfg.RNG_SEED = 3
    return cfg


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert isinstance(g[k], np.ndarray) and g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("balance", [True, False])
def test_prepare_dataset_matches_jax(tmp_path, balance):
    """The JAX run writes the noun table (its seeded fallback); the port
    reads it. Rows equal (exact), ``attributes.csv`` byte-equal."""
    root = str(tmp_path)
    _fixture(root)
    jcfg = _prep_cfg(jax_get_cfg(), root, "jax", balance)
    pcfg = _prep_cfg(get_cfg(), root, "port", balance)
    jax_prepare_dataset(jcfg)
    train_rows, val_rows = prepare_dataset(pcfg)
    for split, rows in (("train", train_rows), ("val", val_rows)):
        want = read_annotations(os.path.join(root, f"jax_{split}.pkl"), index_key="narration_id")
        with open(os.path.join(root, f"port_{split}.pkl"), "rb") as f:
            got = pickle.load(f)
        assert isinstance(got, list) and all("narration_id" in r for r in got)
        _assert_rows_equal(got, want)
        _assert_rows_equal(rows, want)
    transformations = [r["transformation"] for r in train_rows]
    assert transformations.count("none") == 40
    if balance:
        assert len(train_rows) > 40
    else:
        assert len(train_rows) == 40 * (1 + len(get_transforms()))
    assert train_rows[0]["noun_embedding"].shape == (1, 512)
    assert len(train_rows[0]["precs_vec"]) == 13
    with open(jcfg.MODEL.PDDL_ATTRIBUTES, "rb") as a, open(pcfg.MODEL.PDDL_ATTRIBUTES, "rb") as b:
        assert a.read() == b.read()


def test_prepare_dataset_rejects_verbs_missing_from_domain(tmp_path):
    _fixture(str(tmp_path))
    cfg = _prep_cfg(get_cfg(), str(tmp_path), "port")
    cfg.EPICKITCHENS.VERBS = DOMAIN_VERBS + ["peel"]  # not in domain.pddl
    with pytest.raises(AssertionError, match="peel"):
        prepare_dataset(cfg)


def test_augment_unbalanced_adds_every_transform():
    rows = [{"verb_class": 0, "noun_class": 0}, {"verb_class": 1, "noun_class": 1}]
    out = augment_data(rows, get_transforms(), balance=False, factor=1.0, seed=0)
    assert len(out) == 2 * (1 + len(get_transforms()))
    assert [r["transformation"] for r in out].count("none") == 2


_FALLBACK = """
import sys
from asf_tpu_torch.state.dataset_prep import _compute_clip_embeddings, fallback_embedding
sys.modules["transformers"] = None  # the card's machine: no transformers
out = _compute_clip_embeddings([{"id": 0, "key": "pan"}, {"id": 1, "key": "cup:lid"}], "")
sys.stdout.buffer.write(b"".join(out[i]["embedding"].tobytes() for i in (0, 1)))
"""


def test_clip_fallback_is_the_same_in_every_interpreter():
    """Two fresh interpreters with ``PYTHONHASHSEED`` 1 and 2 draw the same
    fallback vectors (the JAX package's ``hash()`` seed would not)."""
    outs = []
    for seed in ("1", "2"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = seed
        proc = subprocess.run([sys.executable, "-c", _FALLBACK], capture_output=True,
                              timeout=120, env=env, cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and len(outs[0]) == 2 * 512 * 4
    v = np.frombuffer(outs[0], np.float32).reshape(2, 512)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-6)


# -- main ---------------------------------------------------------------------------------

_NO_FOREIGN_IMPORTS = """
import runpy, sys
sys.argv = ["asf_tpu_torch.main", "--config", {yaml!r}, "--train", "--device", "cpu"]
runpy.run_module("asf_tpu_torch.main", run_name="__main__")
print(sorted(m for m in ("jax", "pandas", "yaml", "h5py", "sklearn", "asf_tpu")
             if m in sys.modules))
"""


def _main_cfg(epic, root, out):
    """The tiny EPIC verb/noun model on ``epic``'s audio, prepared from its
    list-of-dict originals with 5 of its 6 verbs and the balancing on."""
    verbs = DOMAIN_VERBS[:CLASSES[0]]
    pd.DataFrame({"id": range(len(verbs)), "key": verbs}).to_csv(
        os.path.join(root, "verbs.csv"), index=False)
    pd.DataFrame({"id": range(CLASSES[1]), "key": [f"noun{i}" for i in range(CLASSES[1])]}
                 ).to_csv(os.path.join(root, "nouns.csv"), index=False)
    rng = np.random.default_rng(1)
    with open(os.path.join(root, "emb.pkl"), "wb") as f:
        pickle.dump({i: rng.standard_normal(512).astype(np.float32)
                     for i in range(CLASSES[1])}, f)
    cfg = _model_cfg(get_cfg(), False)
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    cfg.MODEL.PDDL_ATTRIBUTES = os.path.join(root, "attributes.csv")
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchens"
    cfg.AUDIO_DATA.SAMPLING_RATE = SR
    cfg.AUDIO_DATA.CLIP_SECS = CLIP_SECS
    cfg.TEST.NUM_ENSEMBLE_VIEWS = VIEWS
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 4
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.RNG_SEED = 7
    ek = cfg.EPICKITCHENS
    ek.AUDIO_DATA_FILE = os.path.join(epic, "audio")
    ek.ANNOTATIONS_DIR = root
    ek.ORIGINAL_TRAIN_LIST = os.path.join(epic, "train_list.pkl")
    ek.ORIGINAL_VAL_LIST = os.path.join(epic, "val_list.pkl")
    ek.PROCESSED_TRAIN_LIST = os.path.join(root, "full_train.pkl")
    ek.PROCESSED_VAL_LIST = ek.PROCESSED_TEST_LIST = os.path.join(root, "full_val.pkl")
    ek.VERBS_FILE = os.path.join(root, "verbs.csv")
    ek.NOUNS_FILE = os.path.join(root, "nouns.csv")
    ek.VERBS = verbs[:-1]
    ek.STATE.PDDL_DOMAIN = str(ROOT / "pddl" / "domain.pddl")
    ek.STATE.PDDL_PROBLEM = str(ROOT / "pddl" / "problem.pddl")
    ek.STATE.NOUNS_EMBEDDINGS_FILE = os.path.join(root, "emb.pkl")
    ek.AUGMENT.ENABLE = True
    ek.AUGMENT.BALANCE = True
    cfg.OUTPUT_DIR = out
    return cfg


def _scores(cfg):
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "test_scores.pkl"), "rb") as f:
        return pickle.load(f)


def _assert_scores_equal(got, want):
    for key in ("verb_output", "noun_output"):
        np.testing.assert_array_equal(got[key], want[key])
    assert list(got["narration_id"]) == list(want["narration_id"])
    for key in ("verb", "noun"):
        np.testing.assert_array_equal(got["labels"][key], want["labels"][key])


@pytest.fixture(scope="module")
def main_run(epic_root, tmp_path_factory):  # noqa: F811
    """``python -m asf_tpu_torch.main --config tiny.yaml --train --device
    cpu`` in a fresh interpreter: its cfg, YAML and the modules it loaded."""
    root = str(tmp_path_factory.mktemp("main"))
    cfg = _main_cfg(epic_root, root, os.path.join(root, "out_cli"))
    yaml = os.path.join(root, "tiny.yaml")
    with open(yaml, "w") as f:
        f.write(cfg.dump())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as the in-process run below
    proc = subprocess.run([sys.executable, "-c", _NO_FOREIGN_IMPORTS.format(yaml=yaml)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cfg, yaml, proc.stdout.strip().splitlines()[-1]


def test_main_train_prepares_trains_and_tests_as_train_then_test(main_run, tmp_path):
    """The CLI's score pickle equals ``train(cfg)`` then ``test(cfg)``
    called here on the lists it prepared (exact: the same CPU code on the
    same inputs and seeds); the lists hold the kept verbs only, with their
    transformations; no jax, pandas, yaml, h5py or sklearn was loaded."""
    cfg, _, modules = main_run
    assert modules == "[]"
    with open(cfg.EPICKITCHENS.PROCESSED_TRAIN_LIST, "rb") as f:
        rows = pickle.load(f)
    kept = set(range(CLASSES[0] - 1))
    assert rows and {r["verb_class"] for r in rows} <= kept
    assert any(r["transformation"] != "none" for r in rows)
    assert os.path.exists(cfg.MODEL.PDDL_ATTRIBUTES)
    direct = cfg.clone()
    direct.OUTPUT_DIR = str(tmp_path / "out_direct")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CLI's: another count sums the convolutions in another order
    try:
        port_train(direct, device="cpu")
        port_test(direct.clone(), device="cpu")
    finally:
        torch.set_num_threads(threads)
    _assert_scores_equal(_scores(cfg), _scores(direct))


def test_main_test_alone_rescores_the_checkpoint(main_run):
    cfg, yaml, _ = main_run
    want = _scores(cfg)
    os.remove(os.path.join(cfg.OUTPUT_DIR, "scores", "test_scores.pkl"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the CLI's run
    try:
        port_main.main({"config": yaml, "train": False, "test": True, "device": "cpu"})
    finally:
        torch.set_num_threads(threads)
    _assert_scores_equal(_scores(cfg), want)


def test_main_exits_1_without_prepared_lists(main_run, tmp_path):
    cfg, _, _ = main_run
    cfg = cfg.clone()
    cfg.EPICKITCHENS.SKIP_PREPARATION = True
    cfg.EPICKITCHENS.PROCESSED_TRAIN_LIST = str(tmp_path / "missing.pkl")
    yaml = str(tmp_path / "skip.yaml")
    with open(yaml, "w") as f:
        f.write(cfg.dump())
    with pytest.raises(SystemExit) as e:
        port_main.main({"config": yaml, "train": True, "test": False, "device": "cpu"})
    assert e.value.code == 1
    assert port_main.parse_args(["--config", yaml, "--test", "--device", "cpu"]) == {
        "config": yaml, "train": False, "test": True, "device": "cpu"}
