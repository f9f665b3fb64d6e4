"""The port's eval slice against the JAX package's, and the port's guards.

At a tiny geometry (4 kHz, n_fft 256, a depth-26 width-8 AudioSlowFast,
128x32 spectrograms, ALPHA 4, 6 classes, float32) the same seeded waveforms
go through ``asf_tpu``'s ``make_input_pipeline`` + ``model.apply`` (its
Pallas log-mel kernel in interpret mode) and through the port's ``entry``
on the CPU, on the same weights.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.engine.steps import make_input_pipeline as jax_pipeline
from asf_tpu.models import build_model as jax_build_model
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.entry import entry
from asf_tpu_torch.tools.profile_forward import busy_us, group_of

ROOT = Path(__file__).resolve().parents[1]


def tiny(cfg):
    cfg.MODEL.MODEL_NAME = "AudioSlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = [6]
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.RESNET.DEPTH = 26
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.RESNET.FREQUENCY_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.FREQUENCY_DILATIONS = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.SLOWFAST.ALPHA = 4
    cfg.AUDIO_DATA.SAMPLING_RATE = 4000
    cfg.AUDIO_DATA.N_FFT = 256
    cfg.AUDIO_DATA.CLIP_SECS = 0.5  # 1999 samples -> 100 frames, edge-padded to 128
    cfg.AUDIO_DATA.NUM_FRAMES = 128
    cfg.AUDIO_DATA.NUM_FREQUENCIES = 32
    return cfg


@pytest.fixture(scope="module")
def jax_slice():
    cfg = tiny(jax_get_cfg())
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.USE_PALLAS_DSP = True
    cfg.TPU.DSP_PRECISION = "HIGHEST"
    model = jax_build_model(cfg)
    pipeline = jax_pipeline(cfg)

    @jax.jit
    def forward(variables, wave, n_valid):
        return model.apply(variables, pipeline(wave, n_valid, None, train=False), train=False)

    s = int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS)) - 1
    paths = pipeline(jnp.zeros((2, s), jnp.float32), jnp.full((2,), s, jnp.int32), None)
    variables = jax.jit(lambda k, xs: model.init(k, xs, train=False))(jax.random.PRNGKey(0), paths)
    return forward, jax.tree.map(np.asarray, variables), s


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_entry_matches_jax_pipeline_and_model(jax_slice, dtype):
    forward, variables, s = jax_slice
    cfg = tiny(get_cfg())
    cfg.GPU.COMPUTE_DTYPE = "float32"
    fn, (model, example, n_valid_example) = entry(batch=2, device="cpu", cfg=cfg)
    assert example.shape == (2, s) and n_valid_example.tolist() == [s, s]
    model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)

    rng = np.random.default_rng(7)
    if dtype == "int16":
        wave = (rng.standard_normal((2, s)) * 3000).astype(np.int16)
    else:
        wave = (rng.standard_normal((2, s)) * 0.1).astype(np.float32)
    n_valid = np.asarray([s, s // 3], np.int32)
    want = np.asarray(forward(variables, jnp.asarray(wave), jnp.asarray(n_valid)))
    got = fn(model, torch.from_numpy(wave), torch.from_numpy(n_valid)).numpy()
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(batch=1, device="cuda")


def test_profile_busy_time_and_kernel_groups():
    assert busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert busy_us([]) == 0
    assert group_of("void (anonymous namespace)::logmel_kernel<float>(float const*)") == \
        "log-mel kernel"
    assert group_of("(anonymous namespace)::logmel_wide_kernel(__nv_bfloat16 const*)") == \
        "log-mel kernel"
    assert group_of("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>") == \
        "optimizer"
    assert group_of("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == "convolution"
    assert group_of("void at::native::batch_norm_transform_input_kernel<c10::BFloat16>") == \
        "batch norm"
    assert group_of("Memset (Device)") == "other"


# The machine with the card has no JAX, pandas or h5py.
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "asf_tpu", "pandas", "h5py", "yaml", "sklearn"}
# The host data tools that read or write the JAX package's HDF5 archive import
# h5py (inside their main()); every other root stays forbidden for them.
_H5PY_TOOLS = {"tools/hdf5_to_wav.py", "tools/wav_to_hdf5.py"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "asf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {str(p.relative_to(ROOT / "asf_tpu_torch")) for p in files[:-1]}
    assert {"data/vggsound.py", "data/loader.py", "data/prefetch.py", "engine/train_loop.py",
            "engine/eval_loop.py", "engine/meters.py", "checkpoint/manager.py",
            "checkpoint/pyth_names.py", "utils/logging.py", "utils/misc.py",
            "tools/loop_probe.py", "data/fast_rng.py", "config/yaml_lite.py",
            "engine/test_loop.py", "utils/parser.py", "tools/run_net.py",
            "data/epickitchens.py", "data/records.py", "data/transforms.py",
            "models/gru.py", "state/__init__.py", "state/pddl.py",
            "data/epickitchens_slide.py", "parallel/__init__.py", "parallel/dist.py",
            "models/norm.py", "engine/observers.py", "visualization/__init__.py",
            "visualization/plots.py", "visualization/tensorboard_vis.py",
            "visualization/spectrograms.py", "state/dataset_prep.py", "main.py",
            "tools/predict.py", "tools/fix_weights.py", "tools/stress_test.py",
            "tools/extract_audio.py", "tools/wav_to_hdf5.py", "tools/hdf5_to_wav.py"} <= scanned
    exempt = set()
    for path in files:
        rel = str(path.relative_to(ROOT / "asf_tpu_torch")) if path.name != "chip_smoke.py" else ""
        roots = _imported_roots(path)
        bad = roots & (_FORBIDDEN - {"h5py"} if rel in _H5PY_TOOLS else _FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
        if rel in _H5PY_TOOLS and "h5py" in roots:
            exempt.add(rel)
    assert exempt == _H5PY_TOOLS  # the exemption is used, and by these two only


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(Path(cwd) / "chip_smoke.py")], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
