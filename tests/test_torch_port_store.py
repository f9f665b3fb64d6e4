"""The port's device segment store, val replay and host LRU against the JAX package's.

On the CPU at the tiny geometry of the port's other data tests (8 kHz,
0.32 s clips; the synthetic VGG-Sound, EPIC, GRU-chain, PDDL and slide
sets of ``test_torch_port_{data,epic,gru,state,slide}.py``, made from seeds
with numpy): the store's ``gather`` against ``asf_tpu``'s
``gather_in_graph`` bit for bit; every family's store batches for an epoch
against the port's streamed batches (every key) and against ``asf_tpu``'s
store batches (``AsfLoader.attach_store`` plus ``resolve_offsets``), with
int16 on and off; the per-item refs (``get_ref``, ``collate_refs``)
against the vectorised ones; the guards with their log lines; a stored
loader's workers and its rows across 2 and 4 ranks; ``train(cfg)`` and
``test(cfg)`` with the store and the val replay against streaming; the
``DeviceValCache`` replay and its overflow; ``ByteLRUCache`` against
``asf_tpu``'s, and EPIC and GRU batches with the LRU on and off.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from asf_tpu.data import loader as jax_loader
from asf_tpu.data.cache import ByteLRUCache as JaxByteLRUCache
from asf_tpu.data.device_store import DeviceSegmentStore as JaxStore
from asf_tpu.data.device_store import gather_in_graph
from asf_tpu.data.device_store import resolve_offsets as jax_resolve_offsets
from asf_tpu.data.vggsound import Vggsound as JaxVggsound
from asf_tpu_torch.data import loader
from asf_tpu_torch.data.cache import ByteLRUCache
from asf_tpu_torch.data.device_store import DeviceSegmentStore, collate_refs
from asf_tpu_torch.data.prefetch import Prefetcher
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.engine.eval_loop import DeviceValCache, build_val_meter, eval_epoch
from asf_tpu_torch.engine.steps import make_eval_step
from asf_tpu_torch.models import build_model
from test_torch_port_data import SR, _write_wav24, vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_epic import epic_cfgs, epic_root  # noqa: F401  (fixture)
from test_torch_port_gru import gru_cfgs, gru_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg, _untimed, captured
from test_torch_port_slide import slide_cfgs, slide_root  # noqa: F401  (fixture)
from test_torch_port_state import state_cfgs, state_root  # noqa: F401  (fixture)

BUDGET = 64 << 20


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch: the tiny model's many small ops
    otherwise wait on each other's threads when the suite's workers share
    the cores (~300 s against 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the gather ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("shape", [(6,), (3, 4)])
def test_gather_matches_jax_gather_in_graph(dtype, shape):
    """Offsets anywhere in the buffer, the pad offset among them, ``n_valid``
    from 0 to S: the port's gather is ``gather_in_graph`` bit for bit."""
    rng = np.random.default_rng(len(shape) * 10 + np.dtype(dtype).itemsize)
    S = 37
    segs = (rng.standard_normal(500) * 3000).astype(dtype)
    mega = np.concatenate([segs, np.zeros(S, dtype)])
    starts = rng.integers(0, len(segs), shape).astype(np.int32)
    starts.flat[0] = len(segs)  # the trailing zero pad
    n_valid = rng.integers(0, S + 1, shape).astype(np.int32)
    n_valid.flat[-1] = S
    store = DeviceSegmentStore(torch.from_numpy(mega), {}, S)
    assert store.pad_offset == len(segs)
    got = store.gather(torch.from_numpy(starts), torch.from_numpy(n_valid)).numpy()
    want = np.asarray(gather_in_graph(mega, starts, n_valid, S))
    assert got.dtype == want.dtype == dtype and got.shape == (*shape, S)
    np.testing.assert_array_equal(got, want)


# -- every family's batches -----------------------------------------------------

def _vgg(roots, int16):
    return vgg_cfgs(roots["vgg"], int16=int16)


def _epic(roots, int16):
    return epic_cfgs(roots["epic"], int16=int16)


def _gru(roots, int16):
    return gru_cfgs(roots["gru"], "emb", int16=int16)


def _pddl(gru):
    def make(roots, int16):
        jcfg, pcfg = state_cfgs(roots["state"], gru)
        jcfg.TPU.INT16_TRANSFER = pcfg.GPU.INT16_TRANSFER = int16
        return jcfg, pcfg
    return make


def _slide(mode):
    return lambda roots, int16: slide_cfgs(roots["slide"], mode, int16=int16)


# (name, cfgs, split, epoch)
FAMILIES = [
    ("vgg-train", _vgg, "train", 1), ("vgg-test", _vgg, "test", 0),
    ("epic-train", _epic, "train", 1), ("epic-test", _epic, "test", 0),
    ("gru-train", _gru, "train", 1), ("gru-val", _gru, "val", 0),
    ("pddl-train", _pddl(False), "train", 2), ("gru-pddl-val", _pddl(True), "val", 0),
    ("slide-whole-video", _slide("whole_video"), "test", 0),
    ("slide-action-bounds", _slide("action_bounds"), "test", 0),
    ("slide-per-instance", _slide("per_instance"), "test", 0),
]


@pytest.fixture(scope="module")
def roots(vgg_root, epic_root, gru_root, state_root, slide_root):  # noqa: F811
    return {"vgg": vgg_root, "epic": epic_root, "gru": gru_root, "state": state_root,
            "slide": slide_root}


def _device_batches(ld, epoch, store=None) -> list:
    ld.set_epoch(epoch)
    return list(Prefetcher(ld, "cpu", depth=0, store=store))


def _assert_same(got, want, path="batch"):
    """Every key, dtype, shape and value alike."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(got, want), path
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def _store_loader(pcfg, split):
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    ld = loader.construct_loader(pcfg, split)
    store = DeviceSegmentStore.try_build(ld.dataset, BUDGET, "cpu")
    assert store is not None
    return ld, store


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("name,cfgs,split,epoch", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_store_batches_match_streamed_and_jax(roots, name, cfgs, split, epoch, int16):
    jcfg, pcfg = cfgs(roots, int16)
    ld, store = _store_loader(pcfg, split)
    want = _device_batches(ld, epoch)
    assert store.mega.dtype == (torch.int16 if ld.dataset.int16 else torch.float32)
    ld.attach_store(store)
    got = _device_batches(ld, epoch, store)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_same(g, w)

    # the per-item refs collate to the vectorised offset batches
    ld.dataset.set_epoch(epoch)
    for ob in ld:
        refs = [ld.dataset.get_ref(int(i)) for i in ob["index"]]
        _assert_same(collate_refs(refs, store, pcfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS), ob)

    jld = jax_loader.construct_loader(jcfg, split)
    jstore = JaxStore.try_build(jld.dataset, BUDGET)
    jld.attach_store(jstore)
    jld.set_epoch(epoch)
    jbatches = [jax_resolve_offsets(b, jstore, lambda b: b) for b in jld]
    jld.close()
    assert len(jbatches) == len(got)
    for g, j in zip(got, jbatches):
        wave = np.asarray(j["waveform"])
        assert wave.dtype == g["waveform"].numpy().dtype
        np.testing.assert_array_equal(g["waveform"].numpy(), wave)
        for k in ("n_valid", "index", "lengths", "noun_embedding"):
            if k in j:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(j[k]), err_msg=k)
        assert set(g["labels"]) == set(j["labels"])
        for k, v in j["labels"].items():
            np.testing.assert_array_equal(g["labels"][k].numpy(), np.asarray(v), err_msg=k)


# -- the guards ---------------------------------------------------------------------

def _guarded(roots, case, monkeypatch, tmp_path):
    """(dataset, budget bytes, the log line's start) of guard ``case``."""
    if case == "vgg-24-bit":
        # a file that scipy cannot map: no table, as in the JAX package
        root = tmp_path / "vgg24"
        shutil.copytree(roots["vgg"], root)
        name = sorted(os.listdir(root / "audio"))[0]
        _write_wav24(str(root / "audio" / name), SR,
                     np.random.default_rng(24).integers(-2**23, 2**23, int(SR * 0.6)))
        jcfg, pcfg = vgg_cfgs(str(root))
        assert JaxVggsound(jcfg, "train").device_store_table() is None
        return loader.construct_loader(pcfg, "train").dataset, BUDGET, (
            "Device segment store disabled: Vggsound does not support")
    if case == "vgg-over-budget":
        _, pcfg = vgg_cfgs(roots["vgg"])
        return loader.construct_loader(pcfg, "train").dataset, 8 << 10, (
            "Device segment store: Vggsound train exceeds the sample budget")
    _, pcfg = epic_cfgs(roots["epic"], "aug" if case == "transformation" else "train")
    ds = loader.construct_loader(pcfg, "train").dataset
    if case == "transformation":
        return ds, BUDGET, "Device segment store disabled: EpicKitchens does not support"
    if case == "over-budget":
        return ds, 64 << 10, "Device segment store disabled: 16 segments need"
    if case == "2^31":
        monkeypatch.setattr(ds, "device_store_table",
                            lambda budget_samples=None: [(("P01_00", 0, 2**31), 2**31)])
        return ds, 1 << 40, "Device segment store disabled: >2^31 samples"
    if case == "dtype":
        monkeypatch.setattr(ds, "read_segment",
                            lambda key: np.zeros(key[2] - key[1], np.float64))
        return ds, BUDGET, "Device segment store disabled: segment ('P01_"
    return ds, 0, "Device segment store disabled: budget 0"


@pytest.mark.parametrize("case", ["transformation", "over-budget", "vgg-over-budget",
                                  "vgg-24-bit", "2^31", "dtype", "budget-0"])
def test_each_guard_gives_none_with_its_log_line(roots, case, monkeypatch, tmp_path):
    ds, budget, line = _guarded(roots, case, monkeypatch, tmp_path)
    with captured("asf_tpu_torch") as log:
        assert DeviceSegmentStore.try_build(ds, budget, "cpu") is None
    assert [m for m in log.messages if m.startswith(line)], log.messages


# -- the loader: no worker, each rank's rows ------------------------------------------

def test_a_stored_loader_starts_no_worker(roots):
    _, pcfg = vgg_cfgs(roots["vgg"])
    pcfg.DATA_LOADER.NUM_WORKERS = 2
    ld = loader.construct_loader(pcfg, "train")
    ld.attach_store(DeviceSegmentStore.try_build(ld.dataset, BUDGET, "cpu"))
    assert len(list(ld)) == len(ld) and ld.worker_pids() == [] and ld._dl is None
    assert all("wave_start" in b and "waveform" not in b for b in ld)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name,cfgs,split,epoch",
                         [FAMILIES[1], FAMILIES[5]], ids=["vgg-test", "gru-val"])
def test_each_rank_gathers_its_streamed_rows(roots, name, cfgs, split, epoch, ranks):
    """The ragged last batch padded by its last index, ``n_real`` (0 at
    times), ``host_rows`` and the host batch's chain bucket, as streamed."""
    _, pcfg = cfgs(roots, True)
    ld, store = _store_loader(pcfg, split)
    for r in range(ranks):
        ld.local_rank, ld.local_size = r, ranks
        ld.device_store = None
        want = _device_batches(ld, epoch)
        ld.attach_store(store)
        got = _device_batches(ld, epoch, store)
        assert len(got) == len(want) and "n_real" in got[-1]
        for g, w in zip(got, want):
            _assert_same(g, w)


# -- train(cfg), test(cfg) and the val replay -------------------------------------------

def _loop_cfg(root, out, stored: bool):
    _, cfg = vgg_cfgs(root, train_list="all.pkl", val_list="val.pkl")
    _model_cfg(cfg, False)
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = out
    if not stored:
        cfg.GPU.TRAIN_DEVICE_CACHE_MB = cfg.GPU.VAL_DEVICE_CACHE_MB = 0
        cfg.GPU.TEST_DEVICE_CACHE_MB = 0
    return cfg


def test_train_and_test_with_the_store_match_streaming(roots, tmp_path):
    """Two epochs (precise BN and val each; epoch 2's val replayed), then
    test(cfg) from the last checkpoint: the same losses, val records,
    parameters and scores bit for bit."""
    runs = {}
    for stored in (True, False):
        cfg = _loop_cfg(roots["vgg"], str(tmp_path / str(stored)), stored)
        with captured("asf_tpu_torch") as log:
            state = train(cfg, device="cpu")
            cfg.TEST.CHECKPOINT_FILE_PATH = ""
            scores = port_test(cfg, device="cpu")
        runs[stored] = (log, state.model.state_dict(), scores)
    (slog, ssd, sscores), (plog, psd, pscores) = runs[True], runs[False]
    assert [m for m in slog.messages if m.startswith("Device segment store: 15 segments")]
    assert not [m for m in plog.messages if m.startswith("Device segment store: ")]
    for kind in ("train_iter", "val_epoch", "train_epoch"):
        want = _untimed([r for r in plog.stats if r["_type"] == kind])
        got = _untimed([r for r in slog.stats if r["_type"] == kind])
        assert got == want and got, kind
    for k, v in psd.items():
        assert torch.equal(ssd[k], v), k
    for g, w in zip(sscores, pscores):
        np.testing.assert_array_equal(g, w)


def _val_setup(root):
    _, cfg = vgg_cfgs(root, train_list="all.pkl", val_list="val.pkl")
    _model_cfg(cfg, False)
    cfg.DATA_LOADER.NUM_WORKERS = 0
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).eval()
    return cfg, model, make_eval_step(cfg, "cpu"), loader.construct_loader(cfg, "val")


class _Poisoned:
    """A val loader that must not be read."""
    batch_size = 4

    def __iter__(self):
        raise AssertionError("the replay read the loader")

    def __len__(self):
        return 3


def _val_epoch(cfg, model, step, ld, epoch, cache):
    with captured("asf_tpu_torch") as log:
        eval_epoch(ld, model, step, build_val_meter(cfg, 3), epoch, cfg, "cpu",
                   device_cache=cache)
    (rec,) = _untimed([r for r in log.stats if r["_type"] == "val_epoch"])
    return {k: v for k, v in rec.items() if k != "epoch"}


@pytest.mark.parametrize("budget", [BUDGET, 1024])
def test_val_cache_replays_or_overflows_to_streaming(roots, budget):
    """A budget above the val set: epoch 1 keeps its 3 batches and epoch 2
    replays them without the loader; below one batch: the cache empties
    itself and every epoch streams. Either way the records equal a streamed
    epoch's."""
    cfg, model, step, ld = _val_setup(roots["vgg"])
    want = _val_epoch(cfg, model, step, ld, 0, None)
    cache = DeviceValCache(budget)
    assert _val_epoch(cfg, model, step, ld, 0, cache) == want
    if budget == BUDGET:
        assert cache.ready and len(cache.items) == 3
        assert _val_epoch(cfg, model, step, _Poisoned(), 1, cache) == {**want}
    else:
        assert cache.disabled and not cache.ready and not cache.items
        assert _val_epoch(cfg, model, step, ld, 1, cache) == want


# -- the host LRU ---------------------------------------------------------------------

def test_byte_lru_follows_jax_through_the_same_operations():
    rng = np.random.default_rng(9)
    caches = (ByteLRUCache(1000), JaxByteLRUCache(1000))
    arrays = {k: np.arange(int(n), dtype=np.int16) for k, n in
              enumerate(rng.integers(1, 260, 12))}
    arrays[12] = np.zeros(600, np.int16)  # above the budget: never kept
    ops = [("put", int(k)) if rng.uniform() < 0.5 else ("get", int(k))
           for k in rng.integers(0, 13, 200)]
    for op, key in ops:
        out = [getattr(c, op)(key, arrays[key]) if op == "put" else getattr(c, op)(key)
               for c in caches]
        if op == "get":
            assert (out[0] is None) == (out[1] is None), (op, key)
            if out[0] is not None:
                np.testing.assert_array_equal(out[0], out[1])
                with pytest.raises(ValueError):
                    out[0][0] = 1
        got, want = caches
        assert (len(got), got.nbytes, got.hits, got.misses) == (
            len(want), want.nbytes, want.hits, want.misses)
    assert caches[0].hits and caches[0].misses


@pytest.mark.parametrize("name,cfgs,split,epoch", [FAMILIES[2], FAMILIES[4]],
                         ids=["epic", "gru"])
def test_lru_batches_equal_direct_reads_and_hit_in_epoch_2(roots, name, cfgs, split, epoch):
    _, pcfg = cfgs(roots, False)
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    runs = {}
    for mb in (0, 1):
        pcfg.GPU.HOST_WAVEFORM_CACHE_MB = mb
        ld = loader.construct_loader(pcfg, split)
        runs[mb] = [_device_batches(ld, e) for e in (epoch, epoch + 1)], ld.dataset
    (direct, ds0), (cached, ds1) = runs[0], runs[1]
    assert ds0._seg_cache is None and ds1._seg_cache is not None
    for got, want in zip(cached, direct):
        for g, w in zip(got, want):
            _assert_same(g, w)
    segments = len({(ds1._video[r], *ds1._segment(r)) for r in range(len(ds1._video))})
    read = sum(len(b["index"]) for b in cached[1])
    assert len(ds1._seg_cache) == segments and ds1._seg_cache.misses == segments
    assert ds1._seg_cache.hits == 2 * read - segments


def test_an_lru_over_its_budget_turns_itself_off(roots):
    _, pcfg = epic_cfgs(roots["epic"])
    pcfg.GPU.HOST_WAVEFORM_CACHE_MB = 1
    pcfg.AUDIO_DATA.SAMPLING_RATE = 800000  # the same rows, a hundred times the samples
    with captured("asf_tpu_torch") as log:
        ds = loader.construct_loader(pcfg, "train").dataset
    assert ds._seg_cache is None
    assert [m for m in log.messages if m.startswith(
        "Host waveform cache disabled for EpicKitchens train: segment working set")]
