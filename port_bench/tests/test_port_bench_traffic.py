"""The traffic generator: the same files for one seed, the same lengths for
any two, and the reference's reading of the split against the program's."""

from __future__ import annotations

import filecmp

import numpy as np
import pytest
import torch

from port_bench import traffic
from port_bench.reference import inputs
from port_bench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, name, seed, cell="epic-train-b128"):
    c = tiny.cell(cell)
    root = tmp_path / name
    root.mkdir()
    return traffic.write(c.traffic, c.m, seed, str(root), int(c.cfg["RNG_SEED"]),
                         tuple(c.m["num_classes"]))


def test_one_seed_gives_the_same_files(tmp_path):
    a, b = _write(tmp_path, "a", 2**40 + 7), _write(tmp_path, "b", 2**40 + 7)
    assert filecmp.cmp(a.archive, b.archive, shallow=False)
    assert filecmp.cmp(a.annotations, b.annotations, shallow=False)


def test_two_seeds_share_the_lengths_not_the_audio(tmp_path):
    a, b = _write(tmp_path, "a", 1), _write(tmp_path, "b", 2)
    assert (a.num == b.num).all() and (a.start == b.start).all()
    assert not np.array_equal(a.audio[0], b.audio[0])
    assert not np.array_equal(a.verb, b.verb)


def test_lengths_are_the_stated_quantiles():
    t = tiny.cell("epic-train-b128").traffic
    cs = np.sort(traffic.durations_cs(t))
    assert len(cs) == t["unique_actions"]
    median = np.median(cs) / 100.0
    assert median == pytest.approx(t["durations"]["median_s"], rel=0.05)
    assert cs.min() >= t["durations"]["min_s"] * 100 and cs.max() <= t["durations"]["max_s"] * 100


def test_first_epoch_visits_distinct_actions(tmp_path):
    c = tiny.cell("epic-train-b128")
    s = _write(tmp_path, "a", 3)
    order = inputs.train_rows(len(s.start), len(s.start), int(c.cfg["RNG_SEED"]), 0, 0)
    first = s.action[order[: c.traffic["unique_actions"]]]
    assert len(set(first.tolist())) == c.traffic["unique_actions"]


@pytest.mark.parametrize("name", ["epic-train-b128", "epic-gru-train-b16",
                                  "epic-test-b128-10view"])
def test_reference_reads_the_split_as_the_program(tmp_path, name):
    """The port's loader batches, from its device store on the CPU, against
    the reference's own reading of the same split: every sample, valid
    count and class."""
    from asf_tpu_torch.data.device_store import DeviceSegmentStore
    from asf_tpu_torch.data.loader import construct_loader
    from asf_tpu_torch.data.prefetch import Prefetcher

    from port_bench import cells

    c = tiny.cell(name)
    s = _write(tmp_path, "a", 4, name)
    cfg = cells.port_cfg(c.cfg, s, str(tmp_path / "a"))
    split = "test" if c.traffic["kind"] == "test" else "train"
    loader = construct_loader(cfg, split)
    loader.attach_store(DeviceSegmentStore.try_build(loader.dataset, 64 << 20, "cpu"))
    batch = next(iter(Prefetcher(loader, "cpu", depth=0, store=loader.device_store)))
    m, bsz = c.m, int(cfg.TEST.BATCH_SIZE if split == "test" else cfg.TRAIN.BATCH_SIZE)
    clip = int(round(m["sampling_rate"] * m["clip_s"]))
    if split == "test":
        wave, n_valid = inputs.test_views(s, np.arange(bsz), 10, clip)
        rows = np.arange(bsz) // 10
    else:
        rows = inputs.train_rows(len(s.start), bsz, int(cfg.RNG_SEED), 0, 0)
        if m["gru_layers"]:
            wave, n_valid, lengths = inputs.chains(s, rows, m)
            assert batch["host_lengths"] == lengths
        else:
            wave, n_valid = inputs.train_clips(s, rows, clip, int(cfg.RNG_SEED), 0)
    assert np.array_equal(batch["waveform"].numpy(), wave)
    assert np.array_equal(batch["n_valid"].numpy(), n_valid)
    assert np.array_equal(batch["labels"]["verb"].numpy(), s.verb[rows])
    assert np.array_equal(batch["labels"]["noun"].numpy(), s.noun[rows])
