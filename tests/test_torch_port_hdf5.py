"""The port's HDF5 reader and writer (``asf_tpu_torch/data/hdf5.py``, no
h5py) against h5py, and the EPIC datasets reading an archive against the
JAX package's.

The reader: h5py's files of int16, float32, float64 and big-endian int16
datasets, contiguous and chunked (an edge chunk, more than 64 chunks under a
two-level chunk B-tree, deflate and shuffle + deflate, chunks never written,
a header with attributes that continues in a second block), an empty
dataset, 300 datasets under a two-level group B-tree, 4-byte offsets, and a
version 1 superblock (an h5py file moved under one by hand); every read
equal to h5py's, on random ranges (hypothesis) and at chunk boundaries.
``libver="latest"``, lzf, fletcher32, scale-offset, rank 2, a committed
datatype, a group, a fill value other than zero and a file that is not
HDF5 raise, naming what they found.

The writer: h5py reads its files back (names, dtypes, shapes, chunks,
samples), and the port's ``tools/wav_to_hdf5.py`` writes what
``asf_tpu/tools/wav_to_hdf5.py`` writes for the same wav directory.

The datasets: ``test_torch_port_epic.py``'s set (3 videos of 6 s at 8 kHz)
in four archives: int16 in chunks of 0.5 s (the port's tool), float32 on
the 16-bit grid, contiguous (the reference's layout, h5py), float32 off
the grid (samples times 1.0001, the port's writer) and float64 (h5py). The
port's ``EpicKitchens`` (train, transformed train, val, test, train+val),
``EpicKitchensGRU``, ``EpicKitchensWithPDDL`` and ``EpicKitchensSlide``
give the JAX classes' items and batches bit for bit, int16 transfer on and
off; the int16 probe's verdicts are JAX's, on these and on 7 s videos whose
probe reads a mid-file chunk; the loader with 2 workers gives the loader
with 0's batches; and ``run_net --device cpu`` trains and tests from an
archive, scoring as from the wav directory.
"""

import os
import pickle
import shutil
import struct

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.configuration import set_hypothesis_home_dir
from scipy.io import wavfile

import asf_tpu.data.epickitchens as jax_epic
from asf_tpu.data.epickitchens_slide import EpicKitchensSlide as JaxSlide
from asf_tpu.tools import wav_to_hdf5 as jax_wav_to_hdf5
from asf_tpu_torch.data import hdf5, loader
from asf_tpu_torch.data.epickitchens import (
    EpicKitchens,
    EpicKitchensGRU,
    EpicKitchensWithPDDL,
    audio_source,
)
from asf_tpu_torch.data.epickitchens_slide import EpicKitchensSlide
from asf_tpu_torch.tools import hdf5_to_wav, run_net, wav_to_hdf5
from test_torch_port_epic import SR, VIDEOS, _loop_cfgs, epic_cfgs, epic_root  # noqa: F401
from test_torch_port_gru import gru_cfgs, gru_root  # noqa: F401
from test_torch_port_loop import captured
from test_torch_port_slide import slide_cfgs, slide_root  # noqa: F401
from test_torch_port_state import state_cfgs, state_root  # noqa: F401


# -- the reader against h5py -----------------------------------------------------

def _mixed(path):
    """One h5py file of every dataset kind the reader takes; {name: samples}."""
    rng = np.random.default_rng(3)
    i16 = (rng.standard_normal(1000) * 5000).astype(np.int16)
    f32 = rng.standard_normal(1000).astype(np.float32)
    want = {}
    with h5py.File(path, "w") as f:
        for name, data, kw in (
            ("i16", i16, {}),
            ("i16c", i16, {"chunks": (64,)}),  # 15 full chunks and an edge chunk
            ("f32", f32, {}),
            ("f32c", f32, {"chunks": (100,)}),
            ("f64", f32.astype(np.float64) * 3, {"chunks": (50,)}),
            ("be16", i16.astype(">i2"), {}),
            ("be16c", i16.astype(">i2"), {"chunks": (30,)}),
            ("empty", np.zeros(0, np.float32), {}),
            ("deep", np.arange(7 * 200 + 3, dtype=np.int16), {"chunks": (7,)}),  # 201 chunks
            ("gz", f32, {"chunks": (64,), "compression": "gzip"}),
            ("shgz", i16, {"chunks": (64,), "compression": "gzip", "shuffle": True}),
            ("u8", rng.integers(0, 255, 333).astype(np.uint8), {"chunks": (40,)}),
        ):
            f.create_dataset(name, data=data, **kw)
            want[name] = data
        attrs = f.create_dataset("attrs", data=i16[:300], chunks=(64,), track_times=True)
        for i in range(40):  # the header overflows into a continuation block
            attrs.attrs[f"a{i}"] = np.arange(60)
        want["attrs"] = i16[:300]
        f.create_dataset("unalloc", shape=(100,), dtype=np.int16, chunks=(16,))
        f["unalloc"][20:40] = 7  # two chunks written, five never
        want["unalloc"] = np.where((np.arange(100) >= 20) & (np.arange(100) < 40), 7, 0)
        f.create_dataset("unalloc_contig", shape=(50,), dtype=np.float32)
        want["unalloc_contig"] = np.zeros(50, np.float32)
    return want


def _superblock_v1(src, dst, istore_k=32):
    """The h5py file ``src`` under a version 1 superblock: its 4 more bytes
    (the chunk index K and a reserved field) before the base address, and
    the rest of the file 8 bytes on, which a base address of 8 accounts for."""
    raw = open(src, "rb").read()
    assert raw[8] == 0 and raw[13] == 8  # version 0, 8-byte offsets
    head = (raw[:8] + bytes([1]) + raw[9:24] + struct.pack("<HH", istore_k, 0)
            + struct.pack("<Q", 8) + raw[32:96])
    with open(dst, "wb") as f:
        f.write(head + bytes(104 - len(head)) + raw[96:])


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    """{file name: (path, {dataset: samples})}: ``mixed``, ``v1`` (the same
    under a version 1 superblock), ``offsets4`` (4-byte offsets and
    lengths) and ``many`` (300 datasets)."""
    root = tmp_path_factory.mktemp("h5")
    files = {"mixed": (str(root / "mixed.h5"), _mixed(str(root / "mixed.h5")))}
    _superblock_v1(files["mixed"][0], str(root / "v1.h5"))
    files["v1"] = (str(root / "v1.h5"), files["mixed"][1])
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    rng = np.random.default_rng(5)
    want = {f"d{i:02d}": rng.integers(-3000, 3000, 37 + i).astype(np.int16) for i in range(40)}
    with h5py.File(h5py.h5f.create(str(root / "o4.h5").encode(), h5py.h5f.ACC_TRUNC,
                                   fcpl=fcpl)) as f:
        for name, data in want.items():
            f.create_dataset(name, data=data, chunks=(5,) if len(data) % 2 else None)
    files["offsets4"] = (str(root / "o4.h5"), want)
    want = {f"v{i:03d}": np.full(i % 7, i, np.float32) for i in range(300)}
    with h5py.File(root / "many.h5", "w") as f:
        for name, data in want.items():
            f.create_dataset(name, data=data)
    files["many"] = (str(root / "many.h5"), want)
    return files


def _assert_matches_h5py(path, names=None):
    archive = hdf5.Archive(path)
    with h5py.File(path, "r") as f:
        assert archive.names() == list(f)
        for name in names or list(f):
            d = f[name]
            assert archive.dtype(name) == d.dtype and archive.shape(name) == d.shape
            assert archive.chunks(name) == d.chunks
            got = archive.read(name)
            assert got.dtype == d.dtype
            np.testing.assert_array_equal(got, d[()])
    return archive


@pytest.mark.parametrize("name", ["i16", "i16c", "f32", "f32c", "f64", "be16", "be16c", "empty",
                                  "deep", "gz", "shgz", "u8", "attrs", "unalloc",
                                  "unalloc_contig"])
def test_reader_matches_h5py(h5_files, name):
    path, want = h5_files["mixed"]
    archive = _assert_matches_h5py(path, [name])
    np.testing.assert_array_equal(archive.read(name), want[name])
    v1 = hdf5.Archive(h5_files["v1"][0])  # the same bytes under a version 1 superblock
    assert v1.names() == archive.names() and v1.dtype(name) == archive.dtype(name)
    np.testing.assert_array_equal(v1.read(name), want[name])


def test_deep_trees_and_continued_headers_are_what_the_cases_say(h5_files):
    path, _ = h5_files["mixed"]
    archive = hdf5.Archive(path)
    archive.names()
    mm = archive._map()
    assert archive._dataset("deep").chunks == (7,) and mm[archive._dataset("deep").btree + 5] == 1
    assert any(m[0] == 0x10 for m in archive._messages(archive._group()["attrs"]))
    many = hdf5.Archive(h5_files["many"][0])
    btree = struct.unpack_from("<Q", many._map(), 80)[0]  # the root entry's scratch-pad
    assert many._map()[btree + 5] == 1  # 300 names: a two-level group B-tree
    assert hdf5.Archive(h5_files["v1"][0])._map()[8] == 1


@pytest.mark.parametrize("file", ["offsets4", "many"])
def test_reader_matches_h5py_on_other_files(h5_files, file):
    path, want = h5_files[file]
    archive = _assert_matches_h5py(path)
    assert archive.names() == sorted(want)
    for name, data in want.items():
        np.testing.assert_array_equal(archive.read(name), data)


@pytest.mark.parametrize("name", ["i16c", "f64", "be16c", "deep", "shgz", "unalloc", "f32"])
def test_reads_at_chunk_boundaries_match_h5py(h5_files, name):
    path, _ = h5_files["mixed"]
    archive = hdf5.Archive(path)
    with h5py.File(path, "r") as f:
        d = f[name]
        n, c = d.shape[0], (d.chunks or (97,))[0]
        edges = sorted({0, n} | {k * c for k in range(n // c + 1)})
        for e in edges:
            for a, b in ((e - 1, e + 1), (e, e + c), (e - c, e), (e, e), (e - 1, e)):
                a, b = min(max(0, a), n), min(max(0, b), n)
                np.testing.assert_array_equal(archive.read(name, a, b), d[a:b])
        assert archive.read(name, n - 3, n + 50).shape == (3,)  # clipped, as a slice is


@pytest.fixture(scope="module", autouse=True)
def _hypothesis_home(tmp_path_factory):
    """Hypothesis keeps what it writes under the test's temporary directory,
    not in the checkout."""
    set_hypothesis_home_dir(str(tmp_path_factory.mktemp("hypothesis")))


@settings(max_examples=60, deadline=None, database=None)
@given(st.sampled_from(["i16", "i16c", "f32c", "f64", "be16", "be16c", "deep", "gz", "shgz",
                        "attrs", "unalloc"]),
       st.integers(0, 1500), st.integers(0, 1500))
def test_random_reads_match_h5py(h5_files, name, a, b):
    path, want = h5_files["mixed"]
    n = len(want[name])
    a, b = sorted((min(a, n), min(b, n)))
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(hdf5.Archive(path).read(name, a, b), f[name][a:b])


def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.zeros(4))


def _with(path, **kw):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", **kw)


def _committed(path):
    with h5py.File(path, "w") as f:
        f["t"] = np.dtype("int16")
        f.create_dataset("x", data=np.zeros(3, np.int16), dtype=f["t"])


def _a_group(path):
    with h5py.File(path, "w") as f:
        f.create_group("x")


@pytest.mark.parametrize("make,match", [
    (_latest, "superblock version 3"),
    (lambda p: _with(p, data=np.zeros(40), compression="lzf", chunks=(8,)),
     r"filter 32000 \(lzf\)"),
    (lambda p: _with(p, data=np.zeros(40), fletcher32=True, chunks=(8,)), r"\(fletcher32\)"),
    (lambda p: _with(p, data=np.zeros(40), scaleoffset=2, chunks=(8,)), r"\(scaleoffset\)"),
    (lambda p: _with(p, data=np.zeros((4, 2))), "rank 2"),
    (lambda p: _with(p, shape=(10,), dtype=np.int16, fillvalue=5), "fill value other than zero"),
    (lambda p: _with(p, data=np.zeros(3, "S4")), "a string datatype"),
    (_committed, "shared or committed datatype"),
    (_a_group, "is a group"),
    (lambda p: open(p, "wb").write(b"RIFF....WAVEfmt not an archive"), "not an HDF5 file"),
])
def test_what_the_reader_does_not_take_raises_and_says_what(tmp_path, make, match):
    path = str(tmp_path / "x.h5")
    make(path)
    with pytest.raises(ValueError, match=match):
        hdf5.Archive(path).read("x")


def test_an_archive_pickles_its_path_only(h5_files):
    path, want = h5_files["mixed"]
    archive = hdf5.Archive(path)
    np.testing.assert_array_equal(archive.read("deep", 5, 900), want["deep"][5:900])
    state = pickle.dumps(archive)
    assert len(state) < 300 and archive._mm is not None
    back = pickle.loads(state)
    assert back._mm is None
    np.testing.assert_array_equal(back.read("shgz", 3, 700), want["shgz"][3:700])


# -- the writer ----------------------------------------------------------------------

def test_h5py_reads_the_writers_archive(tmp_path):
    rng = np.random.default_rng(8)
    want = {
        "P01_11": (rng.standard_normal(1000) * 9000).astype(np.int16), "P01_100": None,
        "a": rng.standard_normal(70).astype(np.float32), "Z": np.zeros(0, np.float32),
        "deep": np.arange(4 * 130 + 1, dtype=np.int16), "f64": rng.standard_normal(99),
        "be": np.arange(50, dtype=">i2"), "be_f": rng.standard_normal(33).astype(">f4"),
    }
    want["P01_100"] = want["P01_11"][:77]
    chunks = {"P01_11": 300, "deep": 4, "be": 7, "be_f": 33, "f64": 10}
    for i in range(300):  # two levels of group B-tree
        want[f"v{i:03d}"] = np.full(i % 5 + 1, i, np.int16)
    path = str(tmp_path / "w.hdf5")
    with hdf5.Writer(path) as w:
        for name, data in want.items():
            w.add(name, data, chunks.get(name))
    with h5py.File(path, "r") as f:
        assert list(f) == sorted(want)  # strcmp order
        for name, data in want.items():
            d = f[name]
            assert d.dtype == data.dtype and d.shape == data.shape
            assert d.chunks == ((chunks[name],) if name in chunks else None)
            np.testing.assert_array_equal(d[()], data)
    _assert_matches_h5py(path)
    with pytest.raises(ValueError, match="taken"):
        with hdf5.Writer(str(tmp_path / "x.hdf5")) as w:
            w.add("a", np.zeros(3))
            w.add("a", np.zeros(3))


@pytest.fixture(scope="module")
def wav_dir(epic_root, tmp_path_factory):  # noqa: F811
    """The EPIC set's wav files, one shorter than a 0.5 s chunk and an empty one."""
    root = tmp_path_factory.mktemp("wav")
    for name in os.listdir(os.path.join(epic_root, "audio")):
        shutil.copy(os.path.join(epic_root, "audio", name), root / name)
    wavfile.write(str(root / "P02_00.wav"), SR, np.arange(-1000, 2000, 3, dtype=np.int16))
    wavfile.write(str(root / "P02_01.wav"), SR, np.zeros(0, np.int16))
    return str(root)


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("chunk_seconds", ["0.5", "10"])
def test_wav_to_hdf5_writes_what_the_jax_tool_writes(epic_root, wav_dir, tmp_path, int16,  # noqa
                                                     chunk_seconds):
    """h5py reads the same names, dtypes, shapes, chunks and samples from both
    tools' archives, and the JAX ``EpicKitchens`` the same items."""
    args = ["--sampling_rate", str(SR), "--jobs", "2", "--chunk_seconds", chunk_seconds] + (
        ["--int16"] if int16 else [])
    ours, theirs = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    wav_to_hdf5.main([wav_dir, ours] + args)
    jax_wav_to_hdf5.main([wav_dir, theirs] + args)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a) == list(b) == ["P01_00", "P01_01", "P01_02", "P02_00", "P02_01"]
        for name in b:
            assert (a[name].dtype, a[name].shape, a[name].chunks) == (
                b[name].dtype, b[name].shape, b[name].chunks)
            np.testing.assert_array_equal(a[name][()], b[name][()])
        assert a["P01_00"].chunks == ((4000,) if chunk_seconds == "0.5" else (48000,))
        assert a["P02_01"].chunks is None and a["P02_01"].shape == (0,)
    jcfg, _ = epic_cfgs(epic_root, "aug", int16)
    items = []
    for path in (ours, theirs):
        jcfg.EPICKITCHENS.AUDIO_DATA_FILE = path
        ds = jax_epic.EpicKitchens(jcfg, "train+val")
        items.append([ds[i] for i in range(len(ds))])
    for got, want in zip(*items):
        _same(got, want)
    out = tmp_path / "back"
    hdf5_to_wav.main([ours, str(out), "--sampling_rate", str(SR)])
    for name in os.listdir(wav_dir):
        np.testing.assert_array_equal(wavfile.read(str(out / name))[1],
                                      wavfile.read(os.path.join(wav_dir, name))[1])


# -- the datasets against the JAX package --------------------------------------------

def _same(got, want, where="item"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)
        if isinstance(want, np.generic):
            assert np.asarray(got).dtype == want.dtype, where


def _waves(epic_root):  # noqa: F811
    return {f"P01_{v:02d}": wavfile.read(os.path.join(epic_root, "audio", f"P01_{v:02d}.wav"))[1]
            for v in range(VIDEOS)}


@pytest.fixture(scope="module")
def archives(epic_root, tmp_path_factory):  # noqa: F811
    """{kind: path} of the EPIC set's four archives."""
    root = tmp_path_factory.mktemp("archives")
    waves = _waves(epic_root)
    paths = {k: str(root / f"{k}.hdf5") for k in ("int16", "float32", "off_grid", "float64")}
    wav_to_hdf5.main([os.path.join(epic_root, "audio"), paths["int16"], "--sampling_rate",
                      str(SR), "--chunk_seconds", "0.5", "--int16", "--jobs", "1"])
    with h5py.File(paths["float32"], "w") as f:  # the reference's layout: contiguous float32
        for name, wave in waves.items():
            f.create_dataset(name, data=wave.astype(np.float32) / 32768.0)
    with hdf5.Writer(paths["off_grid"]) as w:
        for name, wave in waves.items():
            w.add(name, (wave.astype(np.float32) / 32768.0 * np.float32(1.0001)), 1000)
    with h5py.File(paths["float64"], "w") as f:
        for name, wave in waves.items():
            f.create_dataset(name, data=wave.astype(np.float64) / 32768.0, chunks=(4096,))
    return paths


def _ek(train_list):
    return lambda roots, int16: epic_cfgs(roots["epic"], train_list, int16)


def _gru(roots, int16):
    return gru_cfgs(roots["epic"], "emb", int16)


def _pddl(roots, int16):
    jcfg, pcfg = state_cfgs(roots["epic"], gru=False)
    jcfg.TPU.INT16_TRANSFER = pcfg.GPU.INT16_TRANSFER = int16
    return jcfg, pcfg


def _slide(roots, int16):
    return slide_cfgs(roots["slide"], "whole_video", int16)


EK = (jax_epic.EpicKitchens, EpicKitchens)
# (cfgs, (JAX class, port class), split): the cases of the datasets' test
DATASETS = {
    "train": (_ek("train"), EK, "train"),
    "train_transformed": (_ek("aug"), EK, "train"),
    "val": (_ek("train"), EK, "val"),
    "test": (_ek("train"), EK, "test"),
    "train+val": (_ek("aug"), EK, "train+val"),
    "gru": (_gru, (jax_epic.EpicKitchensGRU, EpicKitchensGRU), "train"),
    "pddl": (_pddl, (jax_epic.EpicKitchensWithPDDL, EpicKitchensWithPDDL), "train"),
    "slide": (_slide, (JaxSlide, EpicKitchensSlide), "test"),
}


@pytest.fixture(scope="module")
def roots(gru_root, state_root, slide_root):  # noqa: F811
    return {"epic": gru_root, "slide": slide_root}


def _pair(roots, case, archive, int16):
    make, (jax_cls, port_cls), split = DATASETS[case]
    jcfg, pcfg = make(roots, int16)
    jcfg.EPICKITCHENS.AUDIO_DATA_FILE = pcfg.EPICKITCHENS.AUDIO_DATA_FILE = archive
    return jax_cls(jcfg, split), port_cls(pcfg, split)


def _verdicts(path):
    st_ = os.stat(path)
    return jax_epic._PCM_GRID_VERDICTS.get((os.path.abspath(path), st_.st_mtime_ns,
                                             st_.st_size), {})


@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("kind", ["int16", "float32", "off_grid", "float64"])
@pytest.mark.parametrize("case", list(DATASETS))
def test_datasets_from_an_archive_match_jax(roots, archives, case, kind, int16):
    jds, pds = _pair(roots, case, archives[kind], int16)
    transformed = case in ("train_transformed", "train+val")
    assert pds.int16 == jds.int16 == (int16 and kind in ("int16", "float32") and not transformed)
    if int16 and not transformed:
        assert audio_source(archives[kind], SR)._verdicts == _verdicts(archives[kind])
    assert len(pds) == len(jds)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            _same(pds[i], jds[i], f"{case} item {i}")
        order = np.random.default_rng(epoch).permutation(len(pds))[:12]
        for i, item in zip(order, pds.get_batch(epoch, order)):
            _same(item, jds[i], f"{case} batch item {i}")


def test_the_off_grid_archive_turns_the_transfer_off_and_says_why(roots, archives):
    with captured("asf_tpu_torch") as log:
        _, pds = _pair(roots, "train", archives["off_grid"], True)
    assert not pds.int16
    assert any("GPU.INT16_TRANSFER disabled for EpicKitchens train: P01_00 is float32 and not "
               "on the 16-bit PCM grid" in w for w in log.warnings), log.warnings
    verdicts = audio_source(archives["off_grid"], SR)._verdicts
    assert verdicts == _verdicts(archives["off_grid"]) and verdicts["P01_00"] is False


def _probe_archive(path, kind):
    """3 videos of 7 s at 8 kHz (56,000 samples: the probe reads 16 Ki from
    the head and 16 Ki from the middle) on the 16-bit grid but where ``kind``
    says: an off-grid sample in the head, in the middle chunk, or past the
    middle chunk (which neither package reads: there also every 50th sample
    is 1.0, which the int16 cast clips), or another dtype."""
    rng = np.random.default_rng(9)
    waves = {f"P01_{v:02d}": (rng.standard_normal(7 * SR) * 3000).astype(np.int16)
             for v in range(VIDEOS)}
    with h5py.File(path, "w") as f:
        for name, wave in waves.items():
            x = wave.astype(np.float32) / 32768.0
            if name == "P01_01":
                if kind in ("head", "middle", "unread"):
                    x[{"head": 100, "middle": 28000, "unread": 50000}[kind]] += 1e-7
                if kind == "unread":  # samples the int16 cast must clip, not wrap
                    x[36200::50] = 1.0
                elif kind == "loud":
                    x[20000] = 1.5  # integral times 32768, outside int16
                elif kind in ("float64", "big_endian", "int16_big_endian"):
                    x = {"float64": x.astype(np.float64), "big_endian": x.astype(">f4"),
                         "int16_big_endian": wave.astype(">i2")}[kind]
            if name == "P01_02" and kind == "missing":
                continue
            f.create_dataset(name, data=x, chunks=(5000,) if name == "P01_00" else None)


@pytest.mark.parametrize("kind,keeps", [
    ("on_grid", True), ("head", False), ("middle", False), ("unread", True), ("loud", False),
    ("float64", False), ("big_endian", False), ("int16_big_endian", False), ("missing", True),
])
def test_probe_verdicts_match_jax(epic_root, tmp_path, kind, keeps):  # noqa: F811
    path = str(tmp_path / f"{kind}.hdf5")
    _probe_archive(path, kind)
    jcfg, pcfg = epic_cfgs(epic_root, "train", True)
    jcfg.EPICKITCHENS.AUDIO_DATA_FILE = pcfg.EPICKITCHENS.AUDIO_DATA_FILE = path
    jds, pds = jax_epic.EpicKitchens(jcfg, "val"), EpicKitchens(pcfg, "val")
    assert pds.int16 == jds.int16 == keeps
    assert audio_source(path, SR)._verdicts == _verdicts(path)
    for i in range(len(pds)):
        if kind == "missing" and pds._video[i] == "P01_02":
            with pytest.raises(KeyError):
                pds[i]
            continue
        _same(pds[i], jds[i], f"{kind} item {i}")


def _batches(ld):
    return [(b["index"], b["waveform"], b["n_valid"], b["labels"]["verb"], b["labels"]["noun"])
            for b in ld]


@pytest.mark.parametrize("kind", ["int16", "off_grid"])
def test_loader_workers_read_the_archive_as_one_process(epic_root, archives, kind):  # noqa: F811
    """Each of 2 spawned workers opens the archive itself: two epochs of
    train batches equal the loader's in this process."""
    got = {}
    for workers in (0, 2):
        _, pcfg = epic_cfgs(epic_root, "train")
        pcfg.EPICKITCHENS.AUDIO_DATA_FILE = archives[kind]
        pcfg.DATA_LOADER.NUM_WORKERS = workers
        ld = loader.construct_loader(pcfg, "train")
        try:
            got[workers] = []
            for epoch in (0, 1):
                loader.shuffle_dataset(ld, epoch)
                got[workers] += _batches(ld)
        finally:
            ld.close()
    assert len(got[0]) == 8
    for a, b in zip(got[0], got[2]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert got[0][0][1].dtype == (np.int16 if kind == "int16" else np.float32)


def test_run_net_trains_then_tests_from_an_archive(epic_root, archives, tmp_path):  # noqa: F811
    """One epoch, then the test rows in 3 views, from a YAML file: the
    archive's run scores as the wav directory's, bit for bit."""
    scores = {}
    for source in ("audio", archives["int16"]):
        _, cfg = _loop_cfgs(epic_root, str(tmp_path), train_list="train")
        cfg.EPICKITCHENS.AUDIO_DATA_FILE = os.path.join(epic_root, source)
        cfg.OUTPUT_DIR = str(tmp_path / os.path.basename(source))
        path = tmp_path / "run.yaml"
        path.write_text(cfg.dump())
        run_net.main(["--cfg", str(path), "--device", "cpu", "TEST.SAVE_RESULTS_PATH", "cli.pkl"])
        with open(os.path.join(cfg.OUTPUT_DIR, "scores", "cli.pkl"), "rb") as f:
            scores[source] = pickle.load(f)
    wav, h5 = scores.values()
    assert h5["verb_output"].shape == (6, 6) and h5["noun_output"].shape == (6, 8)
    for k in ("verb_output", "noun_output"):
        np.testing.assert_array_equal(h5[k], wav[k])
    assert list(h5["narration_id"]) == list(wav["narration_id"])
