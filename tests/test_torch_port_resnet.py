"""The port's single-pathway Slow-only and Fast-only ``ResNet`` against the JAX package's.

At the tiny geometry of ``test_torch_port_loop.py`` (depth 26, width 8,
8 kHz, 64 x 32 spectrograms, float32, TF32 off, the HIGHEST front end) the
JAX model's variables cross over through the port's
``flax_variables_to_torch_state`` and load with ``strict=True``; the same
seeded numpy inputs go through both. Held to ``asf_tpu``: the model with
one head and with two (verb, noun), in eval and train mode, within 1e-5
(float32) and 2e-2 (bf16); ``pack_pathways`` for each arch; a
reference-named ``.pyth`` from the JAX package's ``flax_to_torch_state``
loading with no leaf skipped; one train step (the JAX side with
``ASF_MAXPOOL_SAS_BWD=1``, as ``test_torch_port_train.py`` explains);
``train(cfg)`` of 2 steps with BN frozen, within 1e-4 a leaf; ``test(cfg)``
within 1e-5 (the JAX loops' model init jitted, ``test_torch_port_state.py``).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.checkpoint import manager as jax_cu
from asf_tpu.checkpoint.pyth_converter import flax_to_torch_state
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.dsp.pathways import pack_pathways as jax_pack_pathways
from asf_tpu.engine import optimizer as jax_optim
from asf_tpu.engine import steps as jax_steps
from asf_tpu.engine import train as jax_train
from asf_tpu.engine.test_loop import test as jax_test
from asf_tpu.models import build_model as jax_build_model
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.checkpoint.pyth_names import load_into
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.engine import test as port_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.engine.pipeline import pack_pathways
from asf_tpu_torch.entry import RELEASE_CLASSES, resnet_cfg, train_entry
from asf_tpu_torch.models import build_model
from asf_tpu_torch.utils.torch_setup import disable_tf32
from test_torch_port_data import vgg_cfgs, vgg_root  # noqa: F401  (fixture)
from test_torch_port_loop import _model_cfg, _rel_l2, captured
from test_torch_port_state import jitted_jax_init  # noqa: F401  (fixture)

ARCHS = ("slow", "fast")
HEADS = {1: [6], 2: [6, 8]}
F32_TOL, BF16_TOL = 1e-5, 2e-2


def resnet(cfg, arch, classes=(6,), jax_side=False, dtype="float32"):
    """``_model_cfg``'s tiny geometry with the single-pathway ``ResNet``."""
    _model_cfg(cfg, jax_side)
    cfg.MODEL.MODEL_NAME = "ResNet"
    cfg.MODEL.ARCH = arch
    cfg.MODEL.NUM_CLASSES = list(classes)
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    (cfg.TPU if jax_side else cfg.GPU).COMPUTE_DTYPE = dtype
    return cfg


def _spec(batch=3, seed=0):
    """(B, T, F, 1) numpy spectrograms, the JAX model's NHWC input."""
    return (np.random.default_rng(seed).standard_normal((batch, 64, 32, 1)) * 0.5
            ).astype(np.float32)


def _nchw(x):
    return [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())]


@pytest.fixture(scope="module")
def jax_variables():
    """``get(arch, heads)``: the initial variables of the JAX model with two
    heads, made once an arch; for one head of 6 classes its verb projection
    is the ``projection``."""
    cache = {}

    def get(arch, heads):
        if arch not in cache:
            model = jax_build_model(resnet(jax_get_cfg(), arch, HEADS[2], True))
            init = jax.jit(lambda k, xs: model.init(k, xs, train=False))
            cache[arch] = jax.tree.map(
                np.asarray, init(jax.random.PRNGKey(1), [jnp.asarray(_spec())]))
        variables = cache[arch]
        if heads == 2:
            return variables
        head = {"projection": variables["params"]["head"]["projection_verb"]}
        return {**variables, "params": {**variables["params"], "head": head}}

    return get


def _port_model(arch, heads, variables, dtype="float32"):
    model = build_model(resnet(get_cfg(), arch, HEADS[heads], dtype=dtype), "cpu")
    model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    return model


def _outputs(out):
    """A model's output (one tensor or array, or a verb/noun pair) as float32 numpy arrays."""
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [o.float().numpy() if torch.is_tensor(o) else np.asarray(o, np.float32) for o in outs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train_mode", [False, True])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_flax(jax_variables, arch, heads, train_mode, dtype):
    """Eval probabilities or train logits (each head), and the train-mode BN
    statistics in float32."""
    disable_tf32()
    variables = jax_variables(arch, heads)
    jmodel = jax_build_model(resnet(jax_get_cfg(), arch, HEADS[heads], True, dtype))
    x = _spec(seed=2)
    model = _port_model(arch, heads, variables, dtype).train(train_mode)
    # oneDNN's bf16 convolution on the CPU is wrong for a frequency axis 1-2
    # wide (test_torch_port_model.py); PyTorch's own CPU convolution is right.
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=dtype == "float32"):
        got = _outputs(model(_nchw(x)))
    if train_mode:
        want, mutated = jax.jit(lambda v, xs: jmodel.apply(
            v, xs, train=True, mutable=["batch_stats"]))(variables, [x])
    else:
        want = jax.jit(lambda v, xs: jmodel.apply(v, xs, train=False))(variables, [x])
    want = _outputs(want)
    assert [g.shape for g in got] == [w.shape for w in want] == [(3, c) for c in HEADS[heads]]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    if train_mode and dtype == "float32":
        stats = flax_variables_to_torch_state({"batch_stats": jax.tree.map(
            np.asarray, mutated["batch_stats"])})
        sd = model.state_dict()
        checked = [k for k in stats if k.endswith(("running_mean", "running_var"))]
        for k in checked:
            np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), rtol=0, atol=F32_TOL,
                                       err_msg=k)
        assert len(checked) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                       for m in model.modules())


def test_state_dict_names_and_temporal_kernels():
    """The JAX tree's names, one pathway; Slow-only's stem and s2-s3 are
    1-wide in time, Fast-only's 5 and 3 wide; a one-pathway head."""
    for arch, stem_t, s2_t in (("slow", 1, 1), ("fast", 5, 3)):
        model = build_model(resnet(get_cfg(), arch, [6, 8]), "cpu")
        sd = model.state_dict()
        assert sd["s1.pathway0_stem.conv.weight"].shape[2] == stem_t
        assert sd["s2.pathway0_res0.branch2.a.weight"].shape[2] == s2_t
        assert sd["s5.pathway0_res0.branch2.a.weight"].shape[2] == 3
        assert sd["head.projection_verb.weight"].shape == (6, 8 * 32)
        assert not any("pathway1" in k or "_fuse" in k for k in sd)


@pytest.mark.parametrize("arch", ["slow", "fast", "slowfast"])
def test_pack_pathways_follows_jax(arch):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.MODEL.ARCH = arch
        c.SLOWFAST.ALPHA = 4
    spec = np.random.default_rng(3).standard_normal((2, 64, 32)).astype(np.float32)
    want = jax_pack_pathways(jcfg, jnp.asarray(spec))
    got = pack_pathways(cfg, torch.from_numpy(spec))
    assert len(got) == len(want) == (2 if arch == "slowfast" else 1)
    for g, w in zip(got, want):
        assert g.shape[1] == 1
        np.testing.assert_array_equal(g[:, 0].numpy(), np.asarray(w))


def test_pack_pathways_refuses_an_unknown_arch():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.MODEL.ARCH = jcfg.MODEL.ARCH = "x3d"
    spec = np.zeros((1, 8, 4), np.float32)
    with pytest.raises(NotImplementedError, match="x3d"):
        jax_pack_pathways(jcfg, jnp.asarray(spec))
    with pytest.raises(NotImplementedError, match="x3d"):
        pack_pathways(cfg, torch.from_numpy(spec))


def test_a_verb_noun_resnet_has_no_state_head(tmp_path):
    """With ``ONLY_ACTION_RECOGNITION`` off and an attributes csv, the ResNet
    builds its two projections and leaves ``NUM_CLASSES`` alone, as the
    JAX package's ``build_model`` does (the state check names the SlowFast
    models only)."""
    csv = tmp_path / "attributes.csv"
    csv.write_text("attribute\na\nb\nc\n")
    cfg, jcfg = resnet(get_cfg(), "fast", [6, 8]), resnet(jax_get_cfg(), "fast", [6, 8], True)
    for c in (cfg, jcfg):
        c.MODEL.ONLY_ACTION_RECOGNITION = False
        c.MODEL.PDDL_ATTRIBUTES = str(csv)
    model = build_model(cfg, "cpu")
    jax_build_model(jcfg)
    assert cfg.MODEL.NUM_CLASSES == jcfg.MODEL.NUM_CLASSES == [6, 8]
    heads = {n for n, _ in model.head.named_children()}
    assert heads == {"projection_verb", "projection_noun"}


def test_resnet_cfg_follows_the_release_check():
    """``entry.resnet_cfg`` against ``scripts/verify_release_ckpt.build_cfg``:
    the same model, arch, classes and R50 stage lists; the port's builds."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import verify_release_ckpt as v

    for arch in ARCHS:
        for dataset in RELEASE_CLASSES:
            got, want = resnet_cfg(arch, dataset), v.build_cfg(arch, dataset)
            for key in ("MODEL.MODEL_NAME", "MODEL.ARCH", "MODEL.NUM_CLASSES", "RESNET.DEPTH",
                        "RESNET.WIDTH_PER_GROUP", "RESNET.NUM_BLOCK_TEMP_KERNEL",
                        "RESNET.FREQUENCY_STRIDES", "RESNET.FREQUENCY_DILATIONS",
                        "AUDIO_DATA.NUM_FRAMES", "AUDIO_DATA.NUM_FREQUENCIES"):
                node_g, node_w = got, want
                for part in key.split("."):
                    node_g, node_w = node_g[part], node_w[part]
                assert list(node_g) == list(node_w) if isinstance(node_w, list) \
                    else node_g == node_w, (arch, dataset, key)
            assert got.GPU.COMPUTE_DTYPE == "bfloat16" and got.MODEL.ONLY_ACTION_RECOGNITION
    with pytest.raises(ValueError):
        resnet_cfg("slowfast", "vgg")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_reference_pyth_loads_with_no_leaf_skipped(jax_variables, arch, tmp_path):
    """``asf_tpu``'s ``flax_to_torch_state`` writes the reference names; the
    port's ``load_into`` takes every leaf and the eval outputs are the JAX
    model's within 1e-5."""
    variables = jax_variables(arch, 2)
    path = tmp_path / "ref.pyth"
    torch.save({"model_state": {k: torch.tensor(np.asarray(v)) for k, v in
                                flax_to_torch_state(variables).items()}}, path)
    model = build_model(resnet(get_cfg(), arch, HEADS[2]), "cpu",
                        torch.Generator().manual_seed(9))
    assert load_into(model, torch.load(path)["model_state"]) == []
    jmodel = jax_build_model(resnet(jax_get_cfg(), arch, HEADS[2], True))
    x = _spec(seed=4)
    want = _outputs(jax.jit(lambda v, xs: jmodel.apply(v, xs, train=False))(variables, [x]))
    with torch.no_grad():
        got = _outputs(model.eval()(_nchw(x)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_variables, arch, monkeypatch):
    """One step of waveforms through the front end, the ResNet, the loss and
    nesterov SGD: loss, ``grad_norm`` and the update against the JAX step."""
    monkeypatch.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
    disable_tf32()
    variables = jax_variables(arch, 1)
    jcfg = resnet(vgg_cfgs("")[0], arch, jax_side=True)
    pcfg = resnet(vgg_cfgs("")[1], arch)
    for cfg in (jcfg, pcfg):
        cfg.SOLVER.BASE_LR = 0.01
    jmodel = jax_build_model(jcfg)
    tx = jax_optim.construct_optimizer(jcfg, variables["params"])
    jstate = jax_steps.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]),
                                  step=jnp.zeros((), jnp.int32))
    jstep = jax_steps.make_train_step(jcfg, jmodel, tx)
    step, (state, _) = train_entry(batch=3, dsp_precision="HIGHEST", device="cpu", cfg=pcfg)
    state.model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}

    s = step.pipeline.params.clip_samples
    rng = np.random.default_rng(11)
    n_valid = np.asarray([s, s // 4, s // 2], np.int32)
    wave = (rng.standard_normal((3, s)) * 0.1).astype(np.float32)
    wave[np.arange(s)[None, :] >= n_valid[:, None]] = 0.0
    labels = rng.integers(0, 6, 3)
    jstate, jparts, _ = jstep(jstate, {"waveform": jnp.asarray(wave),
                                       "n_valid": jnp.asarray(n_valid),
                                       "labels": {"class_id": jnp.asarray(labels)}},
                              jnp.float32(0.01), jax.random.PRNGKey(0))
    parts, _ = step(state, {"waveform": torch.from_numpy(wave),
                            "n_valid": torch.from_numpy(n_valid),
                            "labels": {"class_id": torch.from_numpy(labels)}}, 0.01)
    assert abs(parts["loss"].item() - float(jparts["loss"])) <= 2e-5
    np.testing.assert_allclose(parts["grad_norm"].item(), float(jparts["grad_norm"]), rtol=2e-6)
    want = flax_variables_to_torch_state({"params": jax.tree.map(np.asarray, jstate.params)})
    got = state.model.state_dict()
    dg = torch.cat([(got[k] - init[k]).ravel() for k in want]).double()
    dw = torch.cat([(want[k] - init[k]).ravel() for k in want]).double()
    cos = torch.dot(dg, dw) / (dg.norm() * dw.norm())
    assert 1 - cos.item() <= 1e-10 and abs(dg.norm().item() / dw.norm().item() - 1) <= 2e-6


def _loop_cfgs(root, out, arch):
    """(JAX cfg, port cfg) of the VGG-Sound set: 2 train steps of 6 clips,
    val in 6 and 4, BN frozen, no precise BN, the loader in process."""
    jcfg, pcfg = vgg_cfgs(root, batch=6)
    for side, cfg in ((True, jcfg), (False, pcfg)):
        resnet(cfg, arch, jax_side=side)
        cfg.BN.FREEZE = True
        cfg.BN.USE_PRECISE_STATS = False
        cfg.OUTPUT_DIR = os.path.join(out, "jax" if side else "port")
    jcfg.TPU.TEST_DEVICE_CACHE_MB = 0
    pcfg.DATA_LOADER.NUM_WORKERS = 0
    return jcfg, pcfg


def test_train_matches_jax_train(vgg_root, tmp_path, jitted_jax_init):  # noqa: F811
    """The Fast-only model from the same seeded start: every leaf within
    1e-4 relative L2 after 2 steps, the epoch loss within 1e-4."""
    jcfg, pcfg = _loop_cfgs(vgg_root, str(tmp_path), "fast")
    start = str(tmp_path / "start.pyth")
    torch.save({"model_state": build_model(pcfg, "cpu", torch.Generator().manual_seed(5))
                .state_dict(), "epoch": 9}, start)
    for cfg in (jcfg, pcfg):
        cfg.TRAIN.CHECKPOINT_FILE_PATH = start
        cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    with pytest.MonkeyPatch.context() as mp, captured("asf_tpu") as jlog:
        mp.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
        jax_train(jcfg)
    payload = jax_cu.load_checkpoint_dir(jax_cu.get_last_checkpoint(jcfg.OUTPUT_DIR))
    assert int(payload["step"]) == 2
    with captured("asf_tpu_torch") as plog:
        state = train(pcfg, device="cpu")
    assert state.step == 2
    want = flax_variables_to_torch_state(jax.tree.map(np.asarray, payload["model_state"]))
    got = state.model.state_dict()
    assert set(got) == set(want)
    worst = {k: _rel_l2(got[k], w) for k, w in want.items()
             if not k.endswith("num_batches_tracked")}
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])
    (jep,) = [r for r in jlog.stats if r["_type"] == "train_epoch"]
    (pep,) = [r for r in plog.stats if r["_type"] == "train_epoch"]
    assert abs(pep["loss"] - jep["loss"]) <= 1e-4


def test_test_matches_jax_test(jax_variables, vgg_root, tmp_path, jitted_jax_init):  # noqa: F811
    """The Slow-only model: 10 clips in 2 views, ensembled scores within
    1e-5, labels and the pickle's keys equal."""
    jcfg, pcfg = _loop_cfgs(vgg_root, str(tmp_path), "slow")
    path = str(tmp_path / "test.pyth")
    torch.save({"model_state": flax_variables_to_torch_state(jax_variables("slow", 1)),
                "epoch": 3}, path)
    for cfg in (jcfg, pcfg):
        cfg.TEST.CHECKPOINT_FILE_PATH = path
        cfg.TEST.SAVE_RESULTS_PATH = "scores.pkl"
    jpreds, jlabels = jax_test(jcfg)
    preds, labels = port_test(pcfg, device="cpu")
    assert preds.shape == jpreds.shape == (10, 6)
    assert np.abs(preds - jpreds).max() <= F32_TOL
    np.testing.assert_array_equal(labels, jlabels)
    for cfg in (jcfg, pcfg):
        with open(os.path.join(cfg.OUTPUT_DIR, "scores", "scores.pkl"), "rb") as f:
            assert set(pickle.load(f)) == {"output", "labels"}
