"""The port's GRU sequence model (``AudioSlowFastGRU`` on ``EpicKitchensGRU``
chains) against the JAX package's.

The synthetic EPIC set of ``test_torch_port_epic.py`` (8 kHz, 0.32 s clips,
3 videos of 6 s; the JAX package reads its HDF5 archive, the port wav files
of the same samples) read as chains: ``SPECTROGRAM_OVERLAP`` 0.1 and
``MAX_NB_SPECTROGRAMS`` 4, so a 1.0 s action gives 5 windows cut to 4 (each
starting one second after the last: most run past the action and some past
the video), a 0.5 s one 2, a 0.3 s one 1, a 0.2 s one (shorter than a clip)
its whole segment once, and one stops before it starts. The ``emb`` list
adds a 512-wide ``noun_embedding`` to every row. The model is the tiny
depth-26 SlowFast of ``test_torch_port_loop.py`` with a 2-layer
bidirectional GRU of H = 32, 6 verbs and 8 nouns; weights cross from the
JAX package through ``checkpoint/convert.py``. The JAX side's train step
runs with ``ASF_MAXPOOL_SAS_BWD=1`` (``test_torch_port_train.py`` says why)
and ``TPU.GRU_SINGLE_BUCKET`` off, so that both sides pad each batch to its
power-of-two bucket.

Tolerances: float32 1e-5 max abs (the GRU, the head, the model, test
scores); the JAX package's bf16 GRU (bf16 input products and gates, h in
float32) against the port's float32 GRU 2e-2, the bound the bf16 heads are
held to (``test_torch_port_epic.py``); ``train(cfg)`` 1e-4 relative L2 a
leaf; items, batches and collation bit for bit.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.data import loader as jax_loader
from asf_tpu.data.epickitchens import EpicKitchensGRU as JaxEpicKitchensGRU
from asf_tpu.engine import train as jax_train
from asf_tpu.engine.steps import make_input_pipeline as jax_pipeline
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu.models import build_model as jax_build_model
from asf_tpu.models.gru import GRUResNetBasicHead as JaxGRUHead
from asf_tpu.models.gru import TorchGRU as JaxTorchGRU
from asf_tpu_torch.checkpoint import manager as cu
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.checkpoint.pyth_names import torch_state_to_flax
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.data import loader
from asf_tpu_torch.data.epickitchens import EpicKitchensGRU
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.engine.pipeline import make_input_pipeline
from asf_tpu_torch.engine.steps import init_state
from asf_tpu_torch.entry import epic_gru_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.models.gru import GRUResNetBasicHead, host_lengths_of, run_gru
from asf_tpu_torch.tools import run_net
from asf_tpu_torch.utils.parser import load_config, parse_args
from test_torch_port_epic import CLASSES, CLIP_SECS, SR, epic_cfgs, epic_root  # noqa: F401
from test_torch_port_loop import _model_cfg, _rel_l2, captured
from test_torch_port_loop import jitted_jax_init  # noqa: F401  (fixture)

MAX_NB, OVERLAP, HIDDEN = 4, 0.1, 32
F32_TOL, BF16_TOL, SCORE_TOL = 1e-5, 2e-2, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gru(cfg):
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchensGRU"
    cfg.MODEL.MODEL_NAME = "AudioSlowFastGRU"
    cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS = MAX_NB
    cfg.AUDIO_DATA.SPECTROGRAM_OVERLAP = OVERLAP
    cfg.MODEL.GRU_HIDDEN_SIZE = HIDDEN
    cfg.MODEL.GRU_NUM_LAYERS = 2
    return cfg


def gru_cfgs(root, train_list="train", int16=True, batch=4):
    """(JAX cfg, port cfg) of the chains of ``epic_cfgs``' data."""
    jcfg, pcfg = epic_cfgs(root, train_list, int16, batch)
    for cfg in (jcfg, pcfg):
        _gru(cfg)
    jcfg.TPU.GRU_SINGLE_BUCKET = False
    return jcfg, pcfg


@pytest.fixture(scope="module")
def gru_root(epic_root):  # noqa: F811
    """``epic_root`` plus ``emb`` lists: the train rows, each with a seeded
    512-wide ``noun_embedding``."""
    rng = np.random.default_rng(11)
    with open(os.path.join(epic_root, "train_list.pkl"), "rb") as f:
        rows = [{**r, "noun_embedding": rng.standard_normal(512).astype(np.float32)}
                for r in pickle.load(f)]
    with open(os.path.join(epic_root, "emb_list.pkl"), "wb") as f:
        pickle.dump(rows, f)
    pd.DataFrame([{k: v for k, v in r.items() if k != "narration_id"} for r in rows],
                 index=[r["narration_id"] for r in rows]).to_pickle(
        os.path.join(epic_root, "emb.pkl"))
    return epic_root


# -- the GRU ---------------------------------------------------------------------

def _gru_pair(layers, seed=0, n_in=12, hidden=8):
    gru = torch.nn.GRU(n_in, hidden, num_layers=layers, bidirectional=True, batch_first=True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in gru.parameters():
            p.uniform_(-0.5, 0.5, generator=g)
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in gru.named_parameters()}
    return gru, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_gru_matches_jax_torchgru(layers, with_h0, dtype):
    """Lengths 5 (= N), 3, 1 and 4; padded inputs are noise, which packing
    must ignore; padded outputs are zeros on both sides."""
    rng = np.random.default_rng(layers)
    b, n, hidden = 4, 5, 8
    x = rng.standard_normal((b, n, 12)).astype(np.float32)
    lengths = np.asarray([5, 3, 1, 4], np.int32)
    h0 = rng.standard_normal((2 * layers, b, hidden)).astype(np.float32) if with_h0 else None
    gru, params = _gru_pair(layers)
    jgru = JaxTorchGRU(hidden_size=hidden, num_layers=layers, bidirectional=True,
                       dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jgru.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths),
                                 None if h0 is None else jnp.asarray(h0)), np.float32)
    with torch.no_grad():
        got = run_gru(gru, torch.from_numpy(x), lengths.tolist(),
                      None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (b, n, 2 * hidden) and got.dtype == torch.float32
    pad = np.arange(n)[None, :] >= lengths[:, None]
    assert not got.numpy()[pad].any()
    err = np.abs(got.numpy() - want).max()
    assert err <= (BF16_TOL if dtype == "bfloat16" else F32_TOL), err


def test_packing_never_reads_lengths_back_from_the_device():
    lengths = torch.tensor([2, 1])
    assert host_lengths_of(lengths, None) is lengths
    assert host_lengths_of(torch.empty(2, device="meta"), [2, 1]) == [2, 1]
    with pytest.raises(ValueError, match="host_lengths"):
        host_lengths_of(torch.empty(2, device="meta"), None)


# -- the head and the model ----------------------------------------------------------

def _model_cfgs():
    jcfg, pcfg = _model_cfg(get_jax_cfg(), True), _model_cfg(get_cfg(), False)
    for cfg in (jcfg, pcfg):
        _gru(cfg)
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    return jcfg, pcfg


def get_jax_cfg():
    from asf_tpu.config import get_cfg as jax_get_cfg

    return jax_get_cfg()


def _with_stats(variables, seed):
    """``variables`` with BN statistics drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def stat(path, v):
        if path[-1].key == "mean":
            return (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
        return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)

    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])}


@pytest.fixture(scope="module")
def model_setup():
    """Pathways of 3 chains of up to 4 windows, lengths 4, 2 and 1, and the
    JAX model's variables (BN statistics from a seed)."""
    rng = np.random.default_rng(1)
    slow = (rng.standard_normal((3, MAX_NB, 16, 32, 1)) * 0.5).astype(np.float32)
    fast = (rng.standard_normal((3, MAX_NB, 64, 32, 1)) * 0.5).astype(np.float32)
    lengths = np.asarray([4, 2, 1], np.int32)
    jcfg, _ = _model_cfgs()
    model = jax_build_model(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, xs, n: model.init(k, xs, n, None, train=False))(
        jax.random.PRNGKey(2), [jnp.asarray(slow), jnp.asarray(fast)], jnp.asarray(lengths)))
    paths = [torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()) for x in (slow, fast)]
    return _with_stats(variables, 3), [slow, fast], paths, lengths


def _port_model(dtype, variables):
    _, pcfg = _model_cfgs()
    pcfg.GPU.COMPUTE_DTYPE = dtype
    model = build_model(pcfg, "cpu")
    model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    return model


@pytest.mark.parametrize("dtype,train_mode", [("float32", False), ("float32", True),
                                              ("bfloat16", False), ("bfloat16", True)])
def test_gru_model_matches_flax(model_setup, dtype, train_mode):
    """The whole model on the same weights: verb and noun logits (train
    mode, the mean over real windows) and probabilities (eval mode, the
    mean of the softmax over real windows)."""
    variables, xs, paths, lengths = model_setup
    jcfg, _ = _model_cfgs()
    jcfg.TPU.COMPUTE_DTYPE = dtype
    jmodel = jax_build_model(jcfg)
    jxs, jn = [jnp.asarray(x) for x in xs], jnp.asarray(lengths)
    if train_mode:
        want, _ = jax.jit(lambda v, x, n: jmodel.apply(v, x, n, None, train=True,
                                                       mutable=["batch_stats"]))(
            variables, jxs, jn)
    else:
        want = jax.jit(lambda v, x, n: jmodel.apply(v, x, n, None, train=False))(
            variables, jxs, jn)
    model = _port_model(dtype, variables).train(train_mode)
    assert {"head.gru.weight_ih_l1_reverse", "head.projection_to_dim_in.weight"} <= set(
        model.state_dict())
    # oneDNN's bf16 CPU convolution is wrong at this model's narrow s5
    # (test_torch_port_model.py::test_bf16_compute_probabilities_match)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = model(paths, torch.from_numpy(lengths))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w, n in zip(got, want, CLASSES):
        assert g.shape == (3, n) and g.dtype == torch.float32
        err = np.abs(g.numpy() - np.asarray(w, np.float32)).max()
        assert err <= (BF16_TOL if dtype == "bfloat16" else F32_TOL), err
    if not train_mode:
        for g in got:
            np.testing.assert_allclose(g.sum(dim=1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("train_mode", [False, True])
def test_gru_head_matches_flax(train_mode):
    """The head alone on seeded pooled features (6 chains of up to 5 windows)."""
    rng = np.random.default_rng(4)
    b, n, lengths = 6, 5, np.asarray([5, 1, 3, 2, 5, 4], np.int32)
    xs = [rng.standard_normal((b * n, 1, 2, 64)).astype(np.float32),
          rng.standard_normal((b * n, 4, 2, 8)).astype(np.float32)]
    jhead = JaxGRUHead(dim_in=[64, 8], num_classes=list(CLASSES), pool_size=[[1, 2], [4, 2]],
                       gru_hidden_size=HIDDEN, gru_num_layers=2, only_action_recognition=True)
    jxs = [jnp.asarray(x) for x in xs]
    variables = jhead.init(jax.random.PRNGKey(0), jxs, jnp.asarray(lengths), (b, n))
    want = jhead.apply(variables, jxs, jnp.asarray(lengths), (b, n), train=train_mode)
    head = GRUResNetBasicHead([64, 8], list(CLASSES), [[1, 2], [4, 2]],
                              gru_hidden_size=HIDDEN, gru_num_layers=2)
    head.load_state_dict(flax_variables_to_torch_state(jax.tree.map(np.asarray, variables)),
                         strict=True)
    head.train(train_mode)
    with torch.no_grad():
        got = head([torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs],
                   torch.from_numpy(lengths), (b, n))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= F32_TOL


def test_the_state_configuration_points_at_the_roadmap(tmp_path):
    """With ``ONLY_ACTION_RECOGNITION`` off the GRU model carries the state
    head: the attributes' csv adds a third class and the three state
    projections; without it, the config names what is missing."""
    _, pcfg = _model_cfgs()
    pcfg.MODEL.ONLY_ACTION_RECOGNITION = False
    with pytest.raises(ValueError, match="PDDL attributes"):
        build_model(pcfg, "cpu")
    (tmp_path / "attributes.csv").write_text("attribute\nclean\nopen\nwet\n")
    pcfg.MODEL.PDDL_ATTRIBUTES = str(tmp_path / "attributes.csv")
    sd = build_model(pcfg, "cpu").state_dict()
    assert pcfg.MODEL.NUM_CLASSES == [*CLASSES, 3]
    for name in ("projection_min_1", "projection_0", "projection_1"):
        assert sd[f"head.{name}.weight"].shape == (3, sd["head.projection_verb.weight"].shape[1])


def test_gru_weights_draw_from_the_generator():
    """U(-1/sqrt(H), 1/sqrt(H)) for every GRU leaf, the same from the same seed."""
    _, pcfg = _model_cfgs()
    a = build_model(pcfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
    b = build_model(pcfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
    gru = [k for k in a if k.startswith("head.gru.")]
    assert len(gru) == 16
    for k in gru:
        assert torch.equal(a[k], b[k]) and a[k].abs().max() <= HIDDEN ** -0.5
        assert a[k].std() > 0.5 * HIDDEN ** -0.5 / 3 ** 0.5


# -- the converter and the fine-tune load ----------------------------------------

def test_converter_carries_the_gru_leaves(model_setup):
    variables = model_setup[0]
    state = flax_variables_to_torch_state(variables)
    gru = variables["params"]["head"]["gru"]
    assert len(gru) == 16
    for leaf, value in gru.items():
        np.testing.assert_array_equal(state[f"head.gru.{leaf}"].numpy(), value)
    back = torch_state_to_flax(state)
    assert "_skipped_keys" not in back
    for leaf, value in gru.items():
        np.testing.assert_array_equal(back["params"]["head"]["gru"][leaf], value)


def test_an_epic_checkpoint_seeds_the_gru_model(tmp_path):
    """A verb/noun port ``.pyth`` seeds the GRU model: its trunk and both
    projections load, and exactly ``head.gru`` and
    ``head.projection_to_dim_in`` keep their initial values, a warning each."""
    _, cfg = _model_cfgs()
    src_cfg = cfg.clone()
    src_cfg.MODEL.MODEL_NAME = "AudioSlowFast"
    src = init_state(src_cfg, build_model(src_cfg, "cpu", torch.Generator().manual_seed(3)))
    path = cu.save_checkpoint(str(tmp_path / "epic"), src, 0, src_cfg)
    cfg.OUTPUT_DIR = str(tmp_path / "gru")
    cfg.TRAIN.CHECKPOINT_FILE_PATH = path
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(5))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with captured("asf_tpu_torch") as log:
        assert cu.load_train_checkpoint(cfg, init_state(cfg, model)) == 0
    got, want = model.state_dict(), src.model.state_dict()
    kept = {k for k in got if k.startswith(("head.gru.", "head.projection_to_dim_in."))}
    assert len(kept) == 18
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, init[k] if k in kept else want[k]), k
    assert sorted(w.split()[3] for w in log.warnings) == ["head.gru", "head.projection_to_dim_in"]


# -- items, collation and the loader ---------------------------------------------

def _assert_chains_equal(got, want):
    assert got.keys() == want.keys()
    assert got["waveform"].dtype == want["waveform"].dtype
    np.testing.assert_array_equal(got["waveform"], want["waveform"])
    np.testing.assert_array_equal(got["n_valid"], want["n_valid"])
    assert got["n_valid"].dtype == np.int32
    assert got["length"] == want["length"] and got["length"].dtype == np.int32
    np.testing.assert_array_equal(got["noun_embedding"], want["noun_embedding"])
    assert got["noun_embedding"].dtype == np.float32
    assert got["label"] == want["label"]
    assert got["index"] == want["index"]
    assert got["metadata"] == want["metadata"]


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("split,train_list,epoch", [
    ("train", "train", 0), ("train", "aug", 0), ("train", "aug", 1), ("train", "emb", 0),
    ("val", "train", 0), ("test", "train", 0),
])
def test_chain_items_match_jax(gru_root, split, train_list, epoch, int16):
    jcfg, pcfg = gru_cfgs(gru_root, train_list, int16)
    jds, pds = JaxEpicKitchensGRU(jcfg, split), EpicKitchensGRU(pcfg, split)
    jds.set_epoch(epoch)
    pds.set_epoch(epoch)
    assert len(pds) == len(jds) == {"train": 16, "val": 10, "test": 6}[split]  # a test view a row
    assert pds.int16 == jds.int16 == (int16 and train_list != "aug")
    items = [pds[i] for i in range(len(pds))]
    for i, item in enumerate(items):
        _assert_chains_equal(item, jds[i])
    order = np.random.default_rng(epoch).permutation(len(pds))
    for i, item in zip(order, pds.get_batch(epoch, order)):
        _assert_chains_equal(item, jds[i])
    if split == "train":
        rec = {r: jds._audio_records[r] for r in range(16)}
        clip = pds.clip_samples
        # 1.0 s: 5 windows, cut to MAX_NB; the later ones run past the action
        assert rec[0].num_spectrograms == 5 and items[0]["length"] == MAX_NB
        assert items[1]["length"] == 1 and items[1]["n_valid"][0] == 1600  # 0.2 s < a clip
        assert items[6]["length"] == 1 and items[6]["n_valid"][0] == 1  # stop < start
        assert not items[6]["waveform"].any()
        # row 5 starts 0.2 s before the video's end: its second window lies past it
        assert list(items[5]["n_valid"]) == [1600, 1]
        assert any(0 < v < clip for it in items for v in it["n_valid"][1:])
        emb = items[0]["noun_embedding"]
        assert emb.shape == (512,) and (emb.any() == (train_list == "emb"))


def _pure(batch):
    return {k: v for k, v in batch.items() if k != "metadata"}


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in ("waveform", "n_valid", "lengths", "noun_embedding", "index"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["labels"]:
        np.testing.assert_array_equal(got["labels"][k], want["labels"][k])
    assert got["metadata"] == want["metadata"]


@pytest.mark.parametrize("case", ["int16", "float32", "mixed", "embedding"])
def test_collate_matches_jax(gru_root, case):
    """Every train chain in batches of 5, 1 and 3 rows, through both collates
    (buckets of 4, 1 and 2 or 4 windows); padded windows are zeros with
    ``n_valid`` 1. "mixed" puts int16 chains beside float32 ones."""
    _, pcfg = gru_cfgs(gru_root, "emb" if case == "embedding" else "train",
                       int16=case != "float32")
    items = [pds_item for pds_item in EpicKitchensGRU(pcfg, "train").get_batch(0, range(16))]
    if case == "mixed":
        _, fcfg = gru_cfgs(gru_root, int16=False)
        floats = EpicKitchensGRU(fcfg, "train").get_batch(0, range(16))
        items = [f if i % 3 == 1 else it for i, (it, f) in enumerate(zip(items, floats))]
    sizes = set()
    for chunk in ([0, 1, 2, 3, 4], [1], [5, 6, 7], list(range(16))):
        part = [items[i] for i in chunk]
        got, want = loader.collate(part, MAX_NB), jax_loader.collate(part, MAX_NB, False)
        _assert_batches_equal(got, want)
        sizes.add(got["waveform"].shape[1])
        pad = np.arange(got["n_valid"].shape[1])[None, :] >= got["lengths"][:, None]
        assert (got["n_valid"][pad] == 1).all() and not got["waveform"][pad].any()
    assert sizes == {4, 1, 2}
    dtype = {"int16": np.int16, "embedding": np.int16}.get(case, np.float32)
    assert got["waveform"].dtype == dtype


def test_bucket_windows_match_jax():
    for max_n in (4, 20):
        got = [loader.bucket_windows(n, max_n) for n in range(1, 26)]
        assert got == [jax_loader.bucket_windows(n, max_n) for n in range(1, 26)]
    assert sorted({loader.bucket_windows(n, 20) for n in range(1, 21)}) == [1, 2, 4, 8, 16, 20]


@pytest.mark.parametrize("split,train_list,workers", [
    ("train", "emb", 0), ("train", "aug", 2), ("val", "train", 0),
])
def test_loader_matches_jax_order(gru_root, split, train_list, workers):
    jcfg, pcfg = gru_cfgs(gru_root, train_list)
    pcfg.DATA_LOADER.NUM_WORKERS = workers
    jl, pl = jax_loader.construct_loader(jcfg, split), loader.construct_loader(pcfg, split)
    try:
        for epoch in (0, 1):
            loader.shuffle_dataset(pl, epoch)
            jax_loader.shuffle_dataset(jl, epoch)
            got, want = list(pl), list(jl)
            assert len(got) == len(want) == {"train": 4, "val": 3}[split]
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
    finally:
        pl.close()
        jl.close()


def test_padded_windows_give_the_jax_front_end(gru_root):
    """The first 5 train chains collated (bucket 4), through both input
    pipelines (float32 front end): the padded windows' log(1e-6) frames and
    every real one within 1e-5."""
    jcfg, pcfg = gru_cfgs(gru_root)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        _gru(cfg)
    batch = loader.collate(EpicKitchensGRU(pcfg, "train").get_batch(0, range(5)), MAX_NB)
    want = jax_pipeline(jcfg)(jnp.asarray(batch["waveform"]), jnp.asarray(batch["n_valid"]))
    got = make_input_pipeline(pcfg, "cpu")(torch.from_numpy(batch["waveform"]),
                                           torch.from_numpy(batch["n_valid"]))
    pad = np.arange(MAX_NB)[None, :] >= batch["lengths"][:, None]
    assert pad.any()
    for g, w in zip(got, want):
        w = np.asarray(w)[..., 0]
        assert g.shape == (5, MAX_NB, 1) + w.shape[2:]
        g = g[:, :, 0].numpy()
        assert np.abs(g - w).max() <= F32_TOL
        np.testing.assert_allclose(g[pad], np.log(1e-6), rtol=1e-6)


# -- train(cfg), test(cfg) and run_net ------------------------------------------------

def _loop_cfgs(root, out, train_list="emb"):
    """The tiny GRU model on the chains, one epoch of 4 steps (B = 4),
    precise BN over 2 batches, val in 4, 4, 2; BN frozen, as the GRU
    configs have it."""
    jcfg, pcfg = gru_cfgs(root, train_list)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        _gru(cfg)
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.BN.FREEZE = True
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


@pytest.fixture(scope="module")
def start_pyth(tmp_path_factory):
    _, cfg = _model_cfgs()
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(5)).state_dict()
    path = str(tmp_path_factory.mktemp("start") / "start.pyth")
    torch.save({"model_state": sd, "epoch": 9}, path)
    return path


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


def _precise_bn_float64(state_dict, cfg, batches) -> dict:
    """The BN running statistics that precise BN gives over ``batches``,
    computed in float64 by the trunk of a model holding ``state_dict``."""
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict)
    model = model.double().train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum, m.stats_frozen = None, False
    pipeline = make_input_pipeline(cfg, "cpu")
    with torch.no_grad():
        for b in batches:
            paths = pipeline(torch.from_numpy(b["waveform"]), torch.from_numpy(b["n_valid"]))
            model.trunk([p.reshape(-1, *p.shape[2:]).double() for p in paths])
    return model.state_dict()


def test_train_matches_jax_train(gru_root, start_pyth, tmp_path, jitted_jax_init):
    """One epoch of chains with noun embeddings from the same start, then
    val: every parameter and BN mean within 1e-4 relative L2 of the JAX
    package's, the epoch losses and the val accuracies equal to 4 decimals.

    Precise BN runs over the chain batches, padded windows included, as in
    the JAX package; half their windows are padding, whose frames are
    log(1e-6) everywhere. There the JAX package's one-pass BN variance,
    E[x^2] - E[x]^2 in float32 (``asf_tpu/models/norm.py:97-100``), loses
    digits: its running variances lie ~1.1e-4 relative L2 from the float64
    precise BN of its own parameters. So the running variances are held to
    float64 instead: the port's within 1e-5 of the float64 statistics of
    its own parameters on the same two batches (both sides' distances are
    printed)."""
    jcfg, pcfg = _loop_cfgs(gru_root, str(tmp_path))
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
    start = torch.load(start_pyth)["model_state"]
    variances = [k for k in want if k.endswith("running_var")]
    worst = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k in variances:
            continue
        worst[k] = _rel_l2(got[k], w)
        if k.startswith("head.gru."):
            assert not torch.equal(got[k], start[k]), k
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])
    # precise BN recomputed every BN's statistics from the chain batches
    stats = [k for k in got if k.endswith("running_mean")]
    assert all(not torch.equal(got[k], start[k]) for k in stats)
    ld = loader.construct_loader(pcfg, "train")
    batches = [b for _, b in zip(range(pcfg.BN.NUM_BATCHES_PRECISE), ld)]
    assert min((b["n_valid"].shape[1] - b["lengths"]).sum() for b in batches) > 0
    off = {}
    for side, sd in (("port", got), ("asf_tpu", want)):
        ref = _precise_bn_float64(sd, pcfg, batches)
        off[side] = max((_rel_l2(sd[k], ref[k]), k) for k in variances)
    print(f"running variances, worst relative L2 from float64 precise BN: {off}; from each "
          f"other {max(_rel_l2(got[k], want[k]) for k in variances):.3g}")
    assert off["port"][0] <= 1e-5, off

    (jep,), (pep,) = _records(jlog.stats, "train_epoch"), _records(plog.stats, "train_epoch")
    for k in ("loss", "verb_loss", "noun_loss", "action_top1_acc", "verb_top5_acc"):
        assert round(pep[k], 4) == round(jep[k], 4), (k, pep[k], jep[k])
    (jval,), (pval,) = _records(jlog.stats, "val_epoch"), _records(plog.stats, "val_epoch")
    for k in jval:
        if k.endswith("_acc"):
            assert round(pval[k], 4) == round(jval[k], 4), (k, pval[k], jval[k])
    for kind, n in (("train_iter", 4), ("val_iter", 3)):
        assert len(_records(plog.stats, kind)) == len(_records(jlog.stats, kind)) == n


@pytest.fixture(scope="module")
def test_pyth(tmp_path_factory, model_setup):
    path = str(tmp_path_factory.mktemp("weights") / "test.pyth")
    torch.save({"model_state": flax_variables_to_torch_state(model_setup[0]), "epoch": 3}, path)
    return path


def _scores(cfg):
    with open(os.path.join(cfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
        return pickle.load(f)


def test_test_matches_jax_test(gru_root, test_pyth, tmp_path, jitted_jax_init):
    """6 test chains in one view each, B = 4 (the last batch ragged): verb
    and noun scores within 1e-5, labels, narration ids and the pickle's keys
    equal."""
    jcfg, pcfg = _loop_cfgs(gru_root, str(tmp_path))
    for cfg in (jcfg, pcfg):
        cfg.TEST.CHECKPOINT_FILE_PATH = test_pyth
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    with captured("asf_tpu"):
        (jv, jn), (jvl, jnl), jids = jax_test(jcfg)
    with captured("asf_tpu_torch") as plog:
        (pv, pn), (pvl, pnl), pids = port_test(pcfg, device="cpu")
    assert pv.shape == jv.shape == (6, 6) and pn.shape == jn.shape == (6, 8)
    assert max(np.abs(pv - jv).max(), np.abs(pn - jn).max()) <= SCORE_TOL
    np.testing.assert_allclose(pv.sum(axis=1), 1.0, atol=1e-5)  # one view a chain
    for g, w in ((pvl, jvl), (pnl, jnl)):
        np.testing.assert_array_equal(g, w)
    assert list(pids) == list(jids) == [f"P01_{40 + r:03d}" for r in range(6)]
    assert not _records(plog.stats, "test_warn")
    got, want = _scores(pcfg), _scores(jcfg)
    assert got.keys() == want.keys() == {"verb_output", "noun_output", "labels", "narration_id"}
    np.testing.assert_array_equal(got["noun_output"], pn)
    assert list(got["narration_id"]) == list(want["narration_id"])


def test_run_net_trains_then_tests_a_gru_yaml(gru_root, tmp_path):
    _, cfg = _loop_cfgs(gru_root, str(tmp_path), train_list="train")
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


@pytest.mark.parametrize("name", sorted(
    os.path.relpath(os.path.join(d, n), os.path.join(ROOT, "models", "asf", "config"))
    for d, _, names in os.walk(os.path.join(ROOT, "models", "asf", "config"))
    for n in names if n.endswith(".yaml")))
def test_each_repo_yaml_merges_into_the_port_config(name):
    """``run_net --cfg`` takes every config of the repo, the 7 under
    ``slide/`` among the 23 (the keys the observers and the upstream
    DataLoader read included); the GRU ones name the GRU model and dataset,
    the slide ones the sliding-window test set and its windows."""
    cfg = load_config(parse_args(["--cfg", os.path.join(ROOT, "models", "asf", "config", name)]))
    if "gru" in name:
        assert cfg.MODEL.MODEL_NAME == "AudioSlowFastGRU"
        assert cfg.TRAIN.DATASET.startswith("EpicKitchensGRU")
    if name.startswith("slide"):
        assert cfg.TEST.SLIDE.ENABLE and cfg.TEST.DATASET == "EpicKitchensSlide"
        assert cfg.TEST.SLIDE.HOP_SIZE == 0.5 and cfg.TEST.SLIDE.LABEL_FRAME == 0.5


def test_epic_gru_cfg_is_the_yaml_on_the_flagship_trunk():
    cfg = epic_gru_cfg()
    yaml = load_config(parse_args(["--cfg", os.path.join(ROOT, "models", "asf", "config",
                                                          "asf-gru.yaml")]))
    for key in ("MODEL.MODEL_NAME", "MODEL.NUM_CLASSES", "MODEL.GRU_HIDDEN_SIZE",
                "MODEL.GRU_NUM_LAYERS", "MODEL.DROPOUT_RATE", "MODEL.ONLY_ACTION_RECOGNITION",
                "TRAIN.DATASET", "TRAIN.BATCH_SIZE", "TEST.BATCH_SIZE", "AUDIO_DATA.CLIP_SECS",
                "AUDIO_DATA.NUM_FRAMES", "AUDIO_DATA.SPECTROGRAM_OVERLAP",
                "AUDIO_DATA.MAX_NB_SPECTROGRAMS", "BN.FREEZE", "BN.USE_PRECISE_STATS",
                "BN.NUM_BATCHES_PRECISE", "SOLVER.BASE_LR", "SOLVER.LR_POLICY", "SOLVER.STEPS",
                "SOLVER.LRS", "SOLVER.MAX_EPOCH", "SOLVER.MOMENTUM", "SOLVER.WEIGHT_DECAY",
                "SOLVER.WARMUP_EPOCHS", "SOLVER.OPTIMIZING_METHOD",
                "TRAIN.CHECKPOINT_EPOCH_RESET"):
        node, leaf = key.split(".")
        assert cfg[node][leaf] == yaml[node][leaf], key
    assert cfg.RNG_SEED == yaml.RNG_SEED
    assert cfg.RESNET.DEPTH == 50 and cfg.SLOWFAST.ALPHA == 8  # the flagship trunk
    assert cfg.GPU.DSP_PRECISION == "BFLOAT16" and cfg.GPU.COMPUTE_DTYPE == "bfloat16"


def test_a_worker_rebuilds_the_dataset_instead_of_receiving_it(gru_root):
    """What a spawned worker receives is the dataset's class, config and
    split (a few KB, inside one pipe buffer, so the workers start together),
    not its tables (here 16 noun embeddings, 32 KB); the rebuilt dataset
    reads the same batches."""
    _, pcfg = gru_cfgs(gru_root, "emb")
    ld = loader.construct_loader(pcfg, "train")
    batches = loader._Batches(ld.dataset, MAX_NB)
    blob = pickle.dumps(batches)
    assert len(blob) < 16384 < len(pickle.dumps(ld.dataset))
    twin = pickle.loads(blob)
    assert twin.dataset is not ld.dataset and twin.max_windows == MAX_NB
    key = (1, np.asarray([3, 0, 9, 12]))
    _assert_batches_equal(twin[key], batches[key])
