"""The port's PDDL state head against the JAX package's.

The synthetic EPIC set of ``test_torch_port_epic.py`` (8 kHz, 0.32 s clips,
3 videos of 6 s; the JAX package reads its HDF5 archive, the port wav
files of the same samples) with PDDL labels: each row's verb is mapped onto
one of the 33 actions of ``pddl/full_domain.pddl``, whose 30 attributes
give its ``precs_vec``/``posts_vec`` (through the port's copy of
``state/pddl.py``, as ``asf_tpu/state/dataset_prep.py`` derives them), and
each row gets a seeded 512-wide ``noun_embedding``; ``attributes.csv``
lists the attributes. The models are the tiny depth-26 SlowFast of
``test_torch_port_loop.py`` (6 verbs, 8 nouns, 30 attributes) and its GRU
variant with one bidirectional layer of H = 512, the embedding's width, so
that the noun-embedding h0 is on; weights cross from the JAX package
through ``checkpoint/convert.py`` or start both sides from one ``.pyth``.
The JAX train runs with ``ASF_MAXPOOL_SAS_BWD=1`` and ``TPU.GRU_SINGLE_BUCKET``
off (``test_torch_port_gru.py`` says why).

Tolerances: items, batches and state labels bit for bit; the state loss
and the train metrics 1e-6; the heads 1e-5 max abs in float32 and 2e-2 in
bf16 (the bound of the other bf16 heads); ``state_metrics`` 1e-12 of
scikit-learn's; ``train(cfg)`` 1e-4 relative L2 a leaf (BN frozen, no
precise BN: the precise statistics over chains are judged in
``test_torch_port_gru.py``) and the val record's state means 1e-6;
``test(cfg)`` scores 1e-5.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import f1_score, precision_score, recall_score

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.data.epickitchens import EpicKitchensGRUwithPDDL as JaxGRUwithPDDL
from asf_tpu.data.epickitchens import EpicKitchensWithPDDL as JaxWithPDDL
from asf_tpu.engine import metrics as jax_metrics
from asf_tpu.engine import steps as jax_steps
from asf_tpu.engine import train as jax_train
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu.engine.train_loop import check_state_alerts as jax_check_state_alerts
from asf_tpu.models.gru import GRUResNetBasicHead as JaxGRUHead
from asf_tpu.models.heads import ResNetBasicHead as JaxHead
from asf_tpu.state import pddl as jax_pddl
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.checkpoint.pyth_names import load_into
from asf_tpu_torch.data import loader
from asf_tpu_torch.data.epickitchens import EpicKitchensGRUwithPDDL, EpicKitchensWithPDDL
from asf_tpu_torch.data.records import EpicKitchensAudioRecordWithPDDL
from asf_tpu_torch.engine import metrics, steps
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.config import get_cfg as port_get_cfg
from asf_tpu_torch.engine.observers import ScalarLogger
from asf_tpu_torch.engine.train_loop import check_state_alerts
from asf_tpu_torch.entry import epic_gru_state_cfg, epic_state_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.models.gru import GRUResNetBasicHead
from asf_tpu_torch.models.heads import ResNetBasicHead
from asf_tpu_torch.state import pddl
from asf_tpu_torch.tools import run_net
from asf_tpu_torch.utils.parser import load_config, parse_args
from test_alerts import FakeSink
from test_torch_port_epic import CLASSES, epic_cfgs, epic_root  # noqa: F401
from test_torch_port_gru import _gru
from test_torch_port_loop import _model_cfg, _rel_l2, captured
from test_torch_port_loop import _jitted_init_state, jitted_jax_init  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ("pddl/domain.pddl", "pddl/full_domain.pddl")
EMB = 512  # the CLIP noun embedding's width, and so the state GRU's H
F32_TOL, BF16_TOL, LOSS_TOL, METRIC_TOL, SCORE_TOL = 1e-5, 2e-2, 1e-6, 1e-12, 1e-5
STATE_YAMLS = sorted(n for n in os.listdir(os.path.join(ROOT, "models", "asf", "config"))
                     if n.endswith(".yaml") and "state" in n)


# -- the PDDL copy -----------------------------------------------------------------

@pytest.mark.parametrize("domain", DOMAINS)
def test_pddl_copy_matches_jax(domain):
    path = os.path.join(ROOT, domain)
    (acts, attrs), (jacts, jattrs) = pddl.parse_pddl(path), jax_pddl.parse_pddl(path)
    assert attrs == jattrs and len(acts) == len(jacts) > 0
    for a, j in zip(acts, jacts):
        assert a.name == j.name
        assert [str(p) for p in a.preconditions] == [str(p) for p in j.preconditions]
        assert [str(p) for p in a.postconditions] == [str(p) for p in j.postconditions]
        for v, w in zip(a.vectorize(attrs), j.vectorize(jattrs)):
            assert v.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(v, w)
        back = pddl.Predicate.predicates_from_vector(a.vectorize(attrs)[1], attrs, to_str=True)
        assert back == jax_pddl.Predicate.predicates_from_vector(
            j.vectorize(jattrs)[1], jattrs, to_str=True)
    if domain.endswith("full_domain.pddl"):
        assert (len(acts), len(attrs)) == (33, 30)


# -- the state data ------------------------------------------------------------------

def _with_state(rows, actions, attributes, rng):
    """``rows`` with each verb's action vectors and a seeded noun embedding."""
    out = []
    for r in rows:
        pre, post = actions[(5 * r["verb_class"] + 2) % len(actions)].vectorize(attributes)
        out.append({**r, "precs_vec": pre, "posts_vec": post,
                    "noun_embedding": rng.standard_normal(EMB).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def state_root(epic_root):  # noqa: F811
    """``epic_root`` plus ``attributes.csv`` and, for each list,
    ``state_<name>.pkl`` (a DataFrame) and ``state_<name>_list.pkl``."""
    actions, attributes = pddl.parse_pddl(os.path.join(ROOT, "pddl", "full_domain.pddl"))
    pd.DataFrame(attributes, columns=["attribute"]).to_csv(
        os.path.join(epic_root, "attributes.csv"), index=False)
    rng = np.random.default_rng(12)
    for name in ("train", "val", "test"):
        with open(os.path.join(epic_root, f"{name}_list.pkl"), "rb") as f:
            rows = _with_state(pickle.load(f), actions, attributes, rng)
        with open(os.path.join(epic_root, f"state_{name}_list.pkl"), "wb") as f:
            pickle.dump(rows, f)
        pd.DataFrame([{k: v for k, v in r.items() if k != "narration_id"} for r in rows],
                     index=[r["narration_id"] for r in rows]).to_pickle(
            os.path.join(epic_root, f"state_{name}.pkl"))
    return epic_root


def state_cfgs(root, gru: bool, batch=4):
    """(JAX cfg, port cfg) of the state lists: the PDDL datasets, the state
    head on (``ONLY_ACTION_RECOGNITION`` off, ``attributes.csv``)."""
    jcfg, pcfg = epic_cfgs(root, "state_train", batch=batch)
    for cfg, suffix in ((jcfg, ""), (pcfg, "_list")):
        if gru:
            _gru(cfg)
            cfg.MODEL.GRU_HIDDEN_SIZE, cfg.MODEL.GRU_NUM_LAYERS = EMB, 1
        cfg.TRAIN.DATASET = cfg.TEST.DATASET = (
            "EpicKitchensGRUwithPDDL" if gru else "EpicKitchensWithPDDL")
        cfg.EPICKITCHENS.PROCESSED_VAL_LIST = f"state_val{suffix}.pkl"
        cfg.EPICKITCHENS.PROCESSED_TEST_LIST = f"state_test{suffix}.pkl"
        cfg.MODEL.ONLY_ACTION_RECOGNITION = False
        cfg.MODEL.PDDL_ATTRIBUTES = os.path.join(root, "attributes.csv")
    jcfg.TPU.GRU_SINGLE_BUCKET = False
    return jcfg, pcfg


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    assert got["label"].keys() == want["label"].keys() == {"verb", "noun", "precs", "posts"}
    for k in ("precs", "posts"):
        assert got["label"][k].dtype == np.float32 and got["label"][k].shape == (30,)
        np.testing.assert_array_equal(got["label"][k], want["label"][k])
    for k in ("verb", "noun"):
        assert got["label"][k] == want["label"][k]
    for k in ("waveform", "n_valid", "length", "noun_embedding"):
        if k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    assert got["index"] == want["index"] and got["metadata"] == want["metadata"]


@pytest.mark.parametrize("gru,split", [(False, "train"), (False, "test"), (True, "train"),
                                       (True, "val")])
def test_pddl_items_and_batches_match_jax(state_root, gru, split):
    jcfg, pcfg = state_cfgs(state_root, gru)
    jds = (JaxGRUwithPDDL if gru else JaxWithPDDL)(jcfg, split)
    pds = (EpicKitchensGRUwithPDDL if gru else EpicKitchensWithPDDL)(pcfg, split)
    assert len(pds) == len(jds) > 0
    assert pds._labels["precs"].shape == (len(pds) // pds._num_clips, 30)
    assert pds._labels["posts"].dtype == np.float32
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        order = np.random.default_rng(epoch).permutation(len(pds))
        for i, item in zip(order, pds.get_batch(epoch, order)):
            _assert_items_equal(item, jds[i])
            _assert_items_equal(pds[i], jds[i])
    got = loader.collate(pds.get_batch(0, range(5)), 4)
    for k in ("precs", "posts"):
        assert got["labels"][k].shape == (5, 30) and got["labels"][k].dtype == np.float32


def test_a_row_whose_verb_has_no_action_names_itself(state_root):
    _, pcfg = state_cfgs(state_root, False)
    with open(os.path.join(state_root, "state_train_list.pkl"), "rb") as f:
        row = pickle.load(f)[3]
    assert EpicKitchensAudioRecordWithPDDL(row, pcfg).label["posts"].shape == (30,)
    row = {**row, "precs_vec": []}
    with pytest.raises(ValueError, match=f"narration {row['narration_id']}: empty precs_vec"):
        EpicKitchensAudioRecordWithPDDL(row, pcfg).label


# -- labels, loss and metrics ---------------------------------------------------------

def _state_batch(rng, b=5, n=4, p=7):
    precs = rng.integers(-1, 2, (b, p)).astype(np.float32)
    posts = rng.integers(-1, 2, (b, p)).astype(np.float32)
    lengths = np.asarray([4, 1, 3, 2, 4][:b], np.int32)
    return precs, posts, lengths


def test_state_labels_match_jax():
    precs, posts, lengths = _state_batch(np.random.default_rng(0))
    for n in (1, 4, 6):
        want = np.asarray(jax_steps.prepare_state_labels_jnp(
            jnp.asarray(precs), jnp.asarray(posts), jnp.asarray(lengths), n))
        got = steps.prepare_state_labels(torch.from_numpy(precs), torch.from_numpy(posts),
                                         torch.from_numpy(lengths), n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _loss_cfgs(gru: bool):
    from asf_tpu.config import get_cfg as jax_get_cfg
    from asf_tpu_torch.config import get_cfg

    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.MODEL.NUM_CLASSES = [*CLASSES, 7]
        cfg.MODEL.ONLY_ACTION_RECOGNITION = False
        cfg.MODEL.MODEL_NAME = "AudioSlowFastGRU" if gru else "AudioSlowFast"
        out.append(cfg)
    return out


@pytest.mark.parametrize("gru", [False, True])
def test_state_loss_and_train_metrics_match_jax(gru):
    """The (verb + noun + state) / 3 loss and its parts, and the train
    metrics with ``state_pred_max_abs``: chains (B, N, P, 3) with their
    lengths, or single clips (B, P, 3) as one window holding the
    postconditions."""
    rng = np.random.default_rng(1)
    precs, posts, lengths = _state_batch(rng)
    shape = (5, 4, 7, 3) if gru else (5, 7, 3)
    preds = [rng.standard_normal((5, c)).astype(np.float32) for c in CLASSES]
    preds.append(rng.standard_normal(shape).astype(np.float32))
    labels = {"verb": np.asarray([0, 1, 2, 3, 5]), "noun": np.asarray([7, 1, 2, 0, 4]),
              "precs": precs, "posts": posts}
    jcfg, pcfg = _loss_cfgs(gru)
    n = jnp.asarray(lengths) if gru else None
    jlabels = {k: jnp.asarray(v) for k, v in labels.items()}
    jtotal, jparts = jax_steps.make_loss_fn(jcfg)([jnp.asarray(p) for p in preds], jlabels, n)
    jstats = jax_steps.make_device_metrics(jcfg)([jnp.asarray(p) for p in preds], jlabels)
    tlabels = {k: torch.from_numpy(v) for k, v in labels.items()}
    tpreds = tuple(torch.from_numpy(p) for p in preds)
    total, parts = steps.make_loss_fn(pcfg)(tpreds, tlabels,
                                            torch.from_numpy(lengths) if gru else None)
    stats = steps.make_device_metrics(pcfg)(tpreds, tlabels)
    assert parts.keys() == jparts.keys() == {"loss", "verb_loss", "noun_loss", "state_loss"}
    assert stats.keys() == jstats.keys()
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) <= LOSS_TOL, k
    assert abs(float(total) - float(jtotal)) <= LOSS_TOL
    for k in stats:
        assert abs(float(stats[k]) - float(jstats[k])) <= LOSS_TOL * max(1.0, float(jstats[k]))


@pytest.mark.parametrize("case", ["random", "tied", "one_class", "labels_absent"])
def test_state_metrics_match_sklearn(case):
    """Random logits; all-equal logits (every arg max is class 0); one
    class predicted everywhere; labels of one class that the predictions
    never take (precision's zero division)."""
    rng = np.random.default_rng(2)
    b, n, p = 6, 5, 9
    preds = rng.standard_normal((b, n, p, 3)).astype(np.float32)
    classes = rng.integers(0, 3, (b, n, p))
    if case == "tied":
        preds[:] = 0.25
    elif case == "one_class":
        preds[..., 2] += 50.0
    elif case == "labels_absent":
        preds[..., 0] += 50.0
        classes[:] = 1
    labels = np.eye(3, dtype=np.float32)[classes]
    lengths = np.asarray([5, 1, 3, 2, 4, 5])
    # asf_tpu's state_metrics calls scikit-learn
    got, want = (metrics.state_metrics(preds, labels, lengths),
                 jax_metrics.state_metrics(preds, labels, lengths))
    assert got.keys() == want.keys() and len(got) == 14
    for k, v in want.items():
        assert abs(got[k] - v) <= METRIC_TOL, (k, got[k], v)
    y_true, y_pred = classes[1, 0], preds[1, 0].argmax(-1)
    for name, fn in (("f1", f1_score), ("recall", recall_score),
                     ("precision", precision_score)):
        for avg in ("macro", "micro"):
            assert abs(metrics._state_scores(y_true, y_pred)[f"{name}_{avg}"] - fn(
                y_true, y_pred, average=avg, zero_division=0)) <= METRIC_TOL
    with pytest.raises(ValueError, match="windows"):
        metrics.state_metrics(preds[:, 0], labels[:, 0], lengths)


# -- alerts ----------------------------------------------------------------------------

@pytest.mark.parametrize("parts,stats,want", [
    ({"loss": 1.0, "state_loss": 0.9}, {"state_pred_max_abs": 0.05}, ["State looking strange"]),
    ({"loss": 20.0, "state_loss": 55.0}, {"state_pred_max_abs": 3.0}, ["state_loss >= 40"]),
    ({"loss": 1.0, "state_loss": 0.9}, {"state_pred_max_abs": 2.5}, []),
    ({"loss": 1.0}, {}, []),
])
def test_state_alerts_match_jax(parts, stats, want):
    """``tests/test_alerts.py``'s three cases against the JAX package's
    alerts, and the warning the port's ``ScalarLogger`` without sinks logs;
    no sink, no alert."""
    got, jsink = FakeSink(), FakeSink()
    check_state_alerts(parts, stats, got)
    jax_check_state_alerts(parts, stats, jsink)
    assert got.alerts == jsink.alerts and [t for t, _ in got.alerts] == want
    check_state_alerts(parts, stats, None)
    with captured("asf_tpu_torch") as log:
        check_state_alerts(parts, stats, ScalarLogger(port_get_cfg()))
    assert log.warnings == [f"{t}: {m}" for t, m in got.alerts]


# -- the heads ---------------------------------------------------------------------------

def _pooled(rng, rows):
    return [rng.standard_normal((rows, 1, 2, 64)).astype(np.float32),
            rng.standard_normal((rows, 4, 2, 8)).astype(np.float32)]


def _torch_paths(xs):
    return [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in xs]


def _sharpened(variables):
    """``variables`` with the state projections' kernels 100 times their
    init (std 0.01), so that the softmax over the 3 classes is far from
    uniform."""
    params = {**variables["params"]}
    for name in ("projection_min_1", "projection_0", "projection_1"):
        params[name] = {**params[name], "kernel": params[name]["kernel"] * 100.0}
    return {**variables, "params": params}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train_mode", [False, True])
def test_single_clip_state_head_matches_flax(dtype, train_mode):
    """(B, P, 3): the state logits averaged over (t', f') in train mode,
    their softmax over the 3 classes averaged in eval mode (rows sum to 1)."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((4, 2, 4, 64)).astype(np.float32),
          rng.standard_normal((4, 8, 4, 8)).astype(np.float32)]
    classes, jdt = [*CLASSES, 7], (jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jhead = JaxHead(dim_in=[64, 8], num_classes=classes, pool_size=[[1, 2], [4, 2]],
                    with_state=True, dtype=jdt)
    jxs = [jnp.asarray(x) for x in xs]
    variables = _sharpened(jhead.init(jax.random.PRNGKey(0), jxs))
    want = jhead.apply(variables, jxs, train=train_mode)
    head = ResNetBasicHead([64, 8], classes, [[1, 2], [4, 2]], with_state=True,
                           dtype=getattr(torch, dtype))
    head.load_state_dict(flax_variables_to_torch_state(jax.tree.map(np.asarray, variables)),
                         strict=True)
    head.train(train_mode)
    with torch.no_grad():
        got = head(_torch_paths(xs))
    assert len(got) == len(want) == 3 and got[2].shape == (4, 7, 3)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    for g, w in zip(got, want):
        assert np.abs(g.float().numpy() - np.asarray(w, np.float32)).max() <= tol
    if not train_mode:
        np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train_mode", [False, True])
def test_gru_state_head_matches_flax(dtype, train_mode):
    """6 chains of up to 5 windows, an embedding of H = 64 as h0 (the head
    takes any width equal to H; the data's is 512), P = 7: the state
    (B, N, P, 3) is the raw view of each window's (3, P), which a transpose
    would not give; the embedding moves every output."""
    rng = np.random.default_rng(4)
    b, n, lengths, hidden = 6, 5, np.asarray([5, 1, 3, 2, 5, 4], np.int32), 64
    xs, emb = _pooled(rng, b * n), rng.standard_normal((b, hidden)).astype(np.float32)
    classes, jdt = [*CLASSES, 7], (jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jhead = JaxGRUHead(dim_in=[64, 8], num_classes=classes, pool_size=[[1, 2], [4, 2]],
                       gru_hidden_size=hidden, gru_num_layers=1, only_action_recognition=False,
                       dtype=jdt)
    jxs, jn = [jnp.asarray(x) for x in xs], jnp.asarray(lengths)
    variables = _sharpened(jhead.init(jax.random.PRNGKey(0), jxs, jn, (b, n), jnp.asarray(emb)))
    want = jhead.apply(variables, jxs, jn, (b, n), jnp.asarray(emb), train=train_mode)
    head = GRUResNetBasicHead([64, 8], classes, [[1, 2], [4, 2]], gru_hidden_size=hidden,
                              gru_num_layers=1, only_action_recognition=False,
                              dtype=getattr(torch, dtype))
    head.load_state_dict(flax_variables_to_torch_state(jax.tree.map(np.asarray, variables)),
                         strict=True)
    head.train(train_mode)
    tl = torch.from_numpy(lengths)
    with torch.no_grad():
        got = head(_torch_paths(xs), tl, (b, n), noun_embedding=torch.from_numpy(emb))
        no_h0 = head(_torch_paths(xs), tl, (b, n))
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert len(got) == 3 and got[2].shape == (b, n, 7, 3) and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w, np.float32)).max() <= tol
    w = np.asarray(want[2], np.float32)
    as_transpose = got[2].reshape(b, n, 3, 7).transpose(-1, -2).numpy()
    assert np.abs(as_transpose - w).max() > 0.1  # the view is not a transpose
    assert np.abs(no_h0[2].numpy() - w).max() > 0.1  # h0 is read
    if not train_mode:
        np.testing.assert_allclose(got[2].reshape(b * n, 3, 7).sum(1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="GRU_HIDDEN_SIZE"):
        head(_torch_paths(xs), tl, (b, n), noun_embedding=torch.zeros(b, EMB))


# -- the models, the converter and the configurations ----------------------------------

def test_state_projections_convert_and_load_strictly(state_root):
    """A port state model's ``.pyth`` leaves, through the reference names
    (``load_into``) and through Flax variables, into a fresh model with
    ``strict=True``: the three projections of each model arrive."""
    for gru in (False, True):
        _, pcfg = state_cfgs(state_root, gru)
        _model_cfg(pcfg, False)
        pcfg.MODEL.NUM_CLASSES = list(CLASSES)
        if gru:
            pcfg.MODEL.MODEL_NAME = "AudioSlowFastGRU"
        src = build_model(pcfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
        keys = [k for k in src if k.startswith(("head.projection_min_1", "head.projection_0",
                                                 "head.projection_1"))]
        assert len(keys) == 6 and src["head.projection_0.weight"].shape[0] == 30
        dst = build_model(pcfg, "cpu", torch.Generator().manual_seed(2))
        assert load_into(dst, src) == []
        for k in keys:
            assert torch.equal(dst.state_dict()[k], src[k])
        from asf_tpu_torch.checkpoint.pyth_names import torch_state_to_flax

        flax = torch_state_to_flax(src)
        dst.load_state_dict(flax_variables_to_torch_state(flax), strict=True)


def test_a_verb_noun_config_without_attributes_says_so():
    from asf_tpu_torch.config import get_cfg

    cfg = _model_cfg(get_cfg(), False)
    cfg.MODEL.NUM_CLASSES = list(CLASSES)
    cfg.MODEL.ONLY_ACTION_RECOGNITION = False
    for name in ("AudioSlowFast", "AudioSlowFastGRU"):
        cfg.MODEL.MODEL_NAME = name
        with pytest.raises(ValueError, match="PDDL attributes"):
            build_model(cfg, "cpu")


@pytest.mark.parametrize("name", STATE_YAMLS)
def test_each_state_yaml_builds_its_state_model(state_root, name):
    """The repo's state YAMLs with ``MODEL.PDDL_ATTRIBUTES`` given: a third
    class of 30 attributes and the three projections, on the full R50."""
    cfg = load_config(parse_args([
        "--cfg", os.path.join(ROOT, "models", "asf", "config", name),
        "MODEL.PDDL_ATTRIBUTES", os.path.join(state_root, "attributes.csv")]))
    assert not cfg.MODEL.ONLY_ACTION_RECOGNITION
    sd = build_model(cfg, "cpu").state_dict()
    assert cfg.MODEL.NUM_CLASSES == [97, 300, 30]
    assert sd["head.projection_min_1.weight"].shape == (30, 2304)
    assert ("head.gru.weight_hh_l0" in sd) == ("gru" in name)


def test_state_cfgs_are_the_yamls_on_the_flagship_trunk():
    for cfg, name in ((epic_state_cfg(), "asf-state.yaml"),
                      (epic_gru_state_cfg(), "asf-gru-state.yaml")):
        yaml = load_config(parse_args(["--cfg", os.path.join(ROOT, "models", "asf", "config",
                                                              name)]))
        for key in ("MODEL.MODEL_NAME", "MODEL.NUM_CLASSES", "MODEL.ONLY_ACTION_RECOGNITION",
                    "MODEL.GRU_HIDDEN_SIZE", "MODEL.GRU_NUM_LAYERS", "TRAIN.DATASET",
                    "TEST.DATASET", "TRAIN.BATCH_SIZE", "TEST.BATCH_SIZE", "BN.FREEZE",
                    "BN.NUM_BATCHES_PRECISE", "SOLVER.BASE_LR", "SOLVER.STEPS",
                    "SOLVER.MAX_EPOCH", "AUDIO_DATA.NUM_FRAMES", "AUDIO_DATA.CLIP_SECS",
                    "TRAIN.CHECKPOINT_EPOCH_RESET"):
            node, leaf = key.split(".")
            assert cfg[node][leaf] == yaml[node][leaf], (name, key)
        assert cfg.RNG_SEED == yaml.RNG_SEED
        assert cfg.RESNET.DEPTH == 50 and cfg.SLOWFAST.ALPHA == 8
    assert not epic_state_cfg().EPICKITCHENS.SINGLE_BATCH


# -- train(cfg), test(cfg) and run_net -------------------------------------------------

def _loop_cfgs(root, out, gru: bool):
    """The tiny state model on the state lists, one epoch of 4 steps
    (B = 4), val in 4, 4, 2; BN frozen, no precise BN."""
    jcfg, pcfg = state_cfgs(root, gru)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        _model_cfg(cfg, side)
        if gru:
            cfg.MODEL.MODEL_NAME = "AudioSlowFastGRU"
            cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS = 2
        cfg.MODEL.NUM_CLASSES = list(CLASSES)
        cfg.BN.FREEZE = True
        cfg.BN.USE_PRECISE_STATS = False
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    # Every JAX batch padded to MAX_NB_SPECTROGRAMS windows (one compile of
    # its step), which is the bucket of every train batch here: chains of 2
    # windows are half the rows (``s1_fuse``'s BN, exempt from the freeze,
    # counts the padded windows in train mode).
    jcfg.TPU.GRU_SINGLE_BUCKET = True
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


def _records(stats, kind):
    return [r for r in stats if r["_type"] == kind]


def _start_pyth(cfg, path, seed):
    """A ``.pyth`` of ``cfg``'s port model with seeded BN statistics."""
    sd = build_model(cfg.clone(), "cpu", torch.Generator().manual_seed(seed)).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.normal_(0.0, 0.1, generator=g)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=g)
    torch.save({"model_state": sd, "epoch": 3}, path)
    return path


def test_gru_state_train_matches_jax_train(state_root, tmp_path, jitted_jax_init):
    """One epoch of state chains from the same start, then val: every leaf
    within 1e-4 relative L2 of the JAX package's (the state projections and
    the GRU moved), the epoch losses to 4 decimals, and the val record's 14
    ``Val/state/*`` means within 1e-6."""
    jcfg, pcfg = _loop_cfgs(state_root, str(tmp_path), gru=True)
    start = _start_pyth(pcfg, str(tmp_path / "start.pyth"), 5)
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.CHECKPOINT_FILE_PATH = start
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    with pytest.MonkeyPatch.context() as mp, captured("asf_tpu") as jlog:
        mp.setenv("ASF_MAXPOOL_SAS_BWD", "1")
        jax_train(jcfg)
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 4
    with captured("asf_tpu_torch") as plog:
        state = train(pcfg, device="cpu")
    assert state.step == 4 and pcfg.MODEL.NUM_CLASSES == [*CLASSES, 30]
    want = flax_variables_to_torch_state(jax.tree.map(np.asarray, payload["model_state"]))
    got, first = state.model.state_dict(), torch.load(start)["model_state"]
    assert set(got) == set(want)
    worst = {k: _rel_l2(got[k], w) for k, w in want.items()
             if not k.endswith("num_batches_tracked")}
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])
    for k in ("head.projection_min_1.weight", "head.projection_1.bias",
              "head.gru.weight_hh_l0_reverse"):
        assert not torch.equal(got[k], first[k]), k

    ld = loader.construct_loader(pcfg, "train")
    assert {b["n_valid"].shape[1] for b in ld} == {2}  # the JAX side's single bucket
    (jep,), (pep,) = _records(jlog.stats, "train_epoch"), _records(plog.stats, "train_epoch")
    for k in ("loss", "verb_loss", "noun_loss", "state_loss", "action_top1_acc"):
        assert round(pep[k], 4) == round(jep[k], 4), (k, pep[k], jep[k])
    assert all("state_loss" in r for r in _records(plog.stats, "train_iter"))
    (jval,), (pval,) = _records(jlog.stats, "val_epoch"), _records(plog.stats, "val_epoch")
    state_keys = [k for k in jval if k.startswith("Val/state/")]
    assert len(state_keys) == 14 and set(state_keys) <= set(pval)
    for k in state_keys:
        assert abs(pval[k] - jval[k]) <= 1e-6, (k, pval[k], jval[k])
    for k in jval:
        if k.endswith("_acc"):
            assert round(pval[k], 4) == round(jval[k], 4), (k, pval[k], jval[k])
    # the alert sink: the tiny head's state logits stay below 0.1 here
    assert any(w.startswith("State looking strange") for w in plog.warnings)


@pytest.mark.parametrize("gru", [True, False])
def test_state_test_matches_jax_test(state_root, tmp_path, jitted_jax_init, gru):
    """The test rows through the state models, B = 4 chains in one view or
    B = 8 clips in 3 views (the last batch ragged in both): verb and noun
    scores within 1e-5, labels, narration ids and the pickle's keys equal;
    the state output is left aside, as in the JAX package."""
    jcfg, pcfg = _loop_cfgs(state_root, str(tmp_path), gru=gru)
    views = 1 if gru else 3
    for cfg in (jcfg, pcfg):
        cfg.TEST.BATCH_SIZE = 4 if gru else 8  # the trunk's 8 rows of the train test
        cfg.TEST.CHECKPOINT_FILE_PATH = _start_pyth(pcfg, str(tmp_path / "test.pyth"), 7)
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    with captured("asf_tpu"):
        (jv, jn), (jvl, jnl), jids = jax_test(jcfg)
    with captured("asf_tpu_torch"):
        (pv, pn), (pvl, pnl), pids = port_test(pcfg, device="cpu")
    assert pv.shape == jv.shape == (6, 6) and pn.shape == jn.shape == (6, 8)
    assert max(np.abs(pv - jv).max(), np.abs(pn - jn).max()) <= SCORE_TOL
    np.testing.assert_allclose(pv.sum(axis=1), views, atol=1e-5)
    for g, w in ((pvl, jvl), (pnl, jnl)):
        np.testing.assert_array_equal(g, w)
    assert list(pids) == list(jids)
    scores = {}
    for cfg in (jcfg, pcfg):
        with open(os.path.join(cfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
            scores[cfg is pcfg] = pickle.load(f)
    assert scores[True].keys() == scores[False].keys() == {
        "verb_output", "noun_output", "labels", "narration_id"}


def test_run_net_trains_then_tests_the_gru_state_yaml(state_root, tmp_path):
    """``run_net --cfg models/asf/config/asf-gru-state.yaml`` with the data,
    the attributes and the tiny geometry given on the command line: it
    trains one epoch, validates with the state metrics and tests."""
    overrides = {
        "EPICKITCHENS.AUDIO_DATA_FILE": os.path.join(state_root, "audio"),
        "EPICKITCHENS.ANNOTATIONS_DIR": state_root,
        "EPICKITCHENS.PROCESSED_TRAIN_LIST": "state_train_list.pkl",
        "EPICKITCHENS.PROCESSED_VAL_LIST": "state_val_list.pkl",
        "EPICKITCHENS.PROCESSED_TEST_LIST": "state_test_list.pkl",
        "MODEL.PDDL_ATTRIBUTES": os.path.join(state_root, "attributes.csv"),
        "TRAIN.CHECKPOINT_FILE_PATH": "", "OUTPUT_DIR": str(tmp_path / "out"),
        "TRAIN.BATCH_SIZE": 4, "TEST.BATCH_SIZE": 4, "DATA_LOADER.NUM_WORKERS": 0,
        "SOLVER.MAX_EPOCH": 1, "TEST.ENABLE": True, "LOG_PERIOD": 2,
        "AUDIO_DATA.SAMPLING_RATE": 8000, "AUDIO_DATA.CLIP_SECS": 0.32,
        "AUDIO_DATA.N_FFT": 256, "AUDIO_DATA.NUM_FRAMES": 64, "AUDIO_DATA.NUM_FREQUENCIES": 32,
        "AUDIO_DATA.MAX_NB_SPECTROGRAMS": 4, "AUDIO_DATA.SPECTROGRAM_OVERLAP": 0.1,
        "RESNET.DEPTH": 26, "RESNET.WIDTH_PER_GROUP": 8,
        "RESNET.NUM_BLOCK_TEMP_KERNEL": [[1, 1], [1, 1], [1, 1], [1, 1]],
        "MODEL.GRU_NUM_LAYERS": 1, "GPU.COMPUTE_DTYPE": "float32",
        "TEST.SAVE_RESULTS_PATH": "cli.pkl",
    }
    argv = ["--cfg", os.path.join(ROOT, "models", "asf", "config", "asf-gru-state.yaml"),
            "--device", "cpu"]
    for k, v in overrides.items():
        argv += [k, str(v)]
    with captured("asf_tpu_torch") as log:
        run_net.main(argv)
    kinds = [r["_type"] for r in log.stats]
    assert kinds.index("train_epoch") < kinds.index("val_epoch") < kinds.index("test_final")
    (val,) = _records(log.stats, "val_epoch")
    assert sum(k.startswith("Val/state/") for k in val) == 14
    with open(os.path.join(tmp_path, "out", "scores", "cli.pkl"), "rb") as f:
        scores = pickle.load(f)
    assert scores["verb_output"].shape == (6, 97) and scores["noun_output"].shape == (6, 300)
    assert np.isfinite(scores["noun_output"]).all() and len(scores["narration_id"]) == 6
