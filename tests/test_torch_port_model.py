"""AudioSlowFast of the PyTorch port against the JAX package's, on the same weights.

A tiny model (depth 26, width 8, 64x32 spectrograms, ALPHA 4, 6 classes)
is initialised in JAX; its variables cross over through the port's own
``flax_variables_to_torch_state`` and load with ``strict=True``. The same
seeded numpy inputs go through both (NHWC for JAX, NCHW for the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.checkpoint.pyth_converter import flax_to_torch_state
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.models import build_model as jax_build_model
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.models import build_model


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
    cfg.AUDIO_DATA.NUM_FRAMES = 64
    cfg.AUDIO_DATA.NUM_FREQUENCIES = 32
    cfg.SLOWFAST.ALPHA = 4
    return cfg


def _jax_cfg(dtype):
    cfg = tiny(jax_get_cfg())
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def _port(dtype, variables):
    cfg = tiny(get_cfg())
    cfg.GPU.COMPUTE_DTYPE = dtype
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    slow = (rng.standard_normal((3, 16, 32, 1)) * 0.5).astype(np.float32)
    fast = (rng.standard_normal((3, 64, 32, 1)) * 0.5).astype(np.float32)
    jax_model = jax_build_model(_jax_cfg("float32"))
    # jit: one compiled program instead of one compile per eager op
    init = jax.jit(lambda key, xs: jax_model.init(key, xs, train=False))
    variables = init(jax.random.PRNGKey(0), [jnp.asarray(slow), jnp.asarray(fast)])
    variables = jax.tree.map(np.asarray, variables)
    # the port's NCHW inputs
    paths = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in (slow, fast)]
    return jax_model, variables, [slow, fast], paths


def test_eval_probabilities_match(setup):
    jax_model, variables, xs, paths = setup
    want = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, xs))
    model = _port("float32", variables).eval()
    with torch.no_grad():
        got = model(paths).numpy()
    assert got.shape == want.shape == (3, 6)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_train_logits_and_bn_statistics_match(setup):
    jax_model, variables, xs, paths = setup
    want, mutated = jax.jit(
        lambda v, x: jax_model.apply(v, x, train=True, mutable=["batch_stats"])
    )(variables, xs)
    model = _port("float32", variables).train()
    got = model(paths).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)

    stats = flax_variables_to_torch_state(
        {"batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])}
    )
    state = model.state_dict()
    checked = 0
    for key, value in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=2e-5, atol=2e-5)
            checked += 1
    assert checked == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_bf16_compute_probabilities_match(setup):
    jax_model, variables, xs, paths = setup
    bf16_model = jax_build_model(_jax_cfg("bfloat16"))
    want = np.asarray(
        jax.jit(lambda v, x: bf16_model.apply(v, x, train=False))(variables, xs), np.float32
    )
    model = _port("bfloat16", variables).eval()
    # oneDNN's bf16 convolution on the CPU returns wrong values (at times
    # non-finite) when the frequency axis is 1 or 2 wide, as it is in s5 of
    # this tiny model; PyTorch's own CPU convolution is right there.
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = model(paths)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def test_converter_agrees_with_pyth_converter(setup):
    _, variables, _, _ = setup
    ours = flax_variables_to_torch_state(variables)
    theirs = flax_to_torch_state(variables)
    added = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - added == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value))
    assert all(ours[k].item() == 0 for k in added)


def test_state_dict_names_follow_the_jax_tree():
    model = build_model(tiny(get_cfg()), device="cpu")
    keys = set(model.state_dict())
    for key in ("s1.pathway0_stem.conv.weight", "s1.pathway1_stem.bn.running_var",
                "s1_fuse.conv_f2s.weight", "s2.pathway1_res0.branch2.a_bn.weight",
                "s2.pathway0_res0.branch1.weight", "s4_fuse.bn.num_batches_tracked",
                "head.projection.weight", "head.projection.bias"):
        assert key in keys


def test_init_is_seeded_and_follows_the_jax_initialisers():
    cfg = tiny(get_cfg())
    a = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).state_dict()
    b = build_model(cfg, "cpu", torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = build_model(cfg.clone(), "cpu", torch.Generator().manual_seed(4)).s5.pathway0_res0.branch2.c.weight
    # c2-msra fill: std sqrt(2 / fan_out), fan_out = out_channels * kernel area
    assert abs(w.std().item() - (2.0 / w.shape[0]) ** 0.5) < 0.1 * (2.0 / w.shape[0]) ** 0.5
    assert torch.all(a["s2.pathway0_res0.branch2.c_bn.weight"] == 1)
    assert torch.all(a["head.projection.bias"] == 0)
