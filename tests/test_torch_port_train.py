"""The port's train slice against the JAX package's, on the same inputs.

Losses, top-k metrics, the LR policy and the loss/metric composition are
held against their ``asf_tpu`` counterparts on seeded numpy inputs. The
optimizer is held to an exact trajectory: the same injected gradients for
``N_STEPS`` steps into both optimizers, on the tiny SlowFast's parameters,
with the LR schedule moving every step (as
``tests/test_train_trajectory.py:172`` does against the reference). One
whole train step of the tiny SlowFast (float32, TF32 off, the HIGHEST front
end, K1 in interpret mode on the JAX side, SpecAugment and dropout off) is
held against ``asf_tpu.engine.steps.make_train_step``, with and without
``BN.FREEZE``, and the port's step gradients against the same model's in
float64.

The JAX step runs with ``ASF_MAXPOOL_SAS_BWD=1``, XLA's stock max-pool
backward. Under ``jit`` the JAX package's claim-chain backward
(``asf_tpu/ops/maxpool.py:70-129``) matches a window's taps against the
pooled maximum with ``==``; behind the stems' fused BN affine and ReLU some
taps fail that equality on XLA:CPU and their gradient is dropped, so the s1
stems' gradients come out 10-100 % off (the eager claim chain and the stock
backward agree with each other and with the port's float64 gradients).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.checkpoint.pyth_converter import torch_state_to_flax
from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.engine import metrics as jax_metrics
from asf_tpu.engine import optimizer as jax_optim
from asf_tpu.engine import steps as jax_steps
from asf_tpu.models import build_model as jax_build_model
from asf_tpu.models import losses as jax_losses
from asf_tpu.utils import lr_policy as jax_lr_policy
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.engine import metrics, optimizer, steps
from asf_tpu_torch.entry import train_entry
from asf_tpu_torch.models import build_model, losses
from asf_tpu_torch.utils import lr_policy
from asf_tpu_torch.utils.torch_setup import disable_tf32
from test_torch_port_entry import tiny

N_STEPS = 5


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------

def _loss_inputs(name, rng):
    if name == "cross_entropy":
        return rng.standard_normal((8, 11)) * 3, rng.integers(0, 11, 8)
    if name == "bce":
        return rng.uniform(0.0, 1.0, (8, 5)), rng.integers(0, 2, (8, 5)).astype(np.float32)
    if name == "bce_logit":
        return rng.standard_normal((8, 5)) * 4, rng.integers(0, 2, (8, 5)).astype(np.float32)
    if name == "mse":
        return rng.standard_normal((8, 5)), rng.standard_normal((8, 5))
    # masked_loss: labels in {-1, 0, 1}, -10 marking padding
    return rng.uniform(-1.0, 1.0, (6, 4, 7)), rng.choice([-10.0, -1.0, 0.0, 1.0], (6, 4, 7))


@pytest.mark.parametrize("name", ["cross_entropy", "bce", "bce_logit", "mse", "masked_loss"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(name, dtype):
    """Every loss computes in float32; bf16 inputs are rounded the same way on both sides."""
    preds, labels = _loss_inputs(name, _rng(len(name)))
    preds = preds.astype(np.float32)
    want = jax_losses.get_loss_func(name)(jnp.asarray(preds, dtype), jnp.asarray(labels))
    got = losses.get_loss_func(name)(
        torch.from_numpy(preds).to(getattr(torch, dtype)), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_state_cross_entropy_matches_jax():
    rng = _rng(3)
    preds = (rng.standard_normal((3, 4, 5, 3)) * 2).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 4, 5))]
    labels[0, 2:] = -1.0  # padded windows
    labels[2, 3] = -1.0
    want = jax_losses.state_cross_entropy(jnp.asarray(preds), jnp.asarray(labels))
    got = losses.state_cross_entropy(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses.get_loss_func("hinge")


def test_topk_metrics_match_jax():
    rng = _rng(4)
    preds = [rng.standard_normal((32, 12)).astype(np.float32) for _ in range(2)]
    labels = [rng.integers(0, 12, 32) for _ in range(2)]
    tp, tl = [torch.from_numpy(p) for p in preds], [torch.from_numpy(x) for x in labels]
    jp, jl = [jnp.asarray(p) for p in preds], [jnp.asarray(x) for x in labels]
    for ks in [(1,), (1, 5), (2, 3, 7)]:
        for got, want in [
            (metrics.topks_correct(tp[0], tl[0], ks), jax_metrics.topks_correct(jp[0], jl[0], ks)),
            (metrics.topk_accuracies(tp[0], tl[0], ks),
             jax_metrics.topk_accuracies(jp[0], jl[0], ks)),
            (metrics.multitask_topks_correct(tp, tl, ks),
             jax_metrics.multitask_topks_correct(jp, jl, ks)),
            (metrics.multitask_topk_accuracies(tp, tl, ks),
             jax_metrics.multitask_topk_accuracies(jp, jl, ks)),
        ]:
            np.testing.assert_allclose([g.item() for g in got], [float(w) for w in want],
                                       rtol=1e-6)


@pytest.mark.parametrize("num_classes", [[6], [6, 8]])
def test_loss_and_device_metrics_match_jax(num_classes):
    """``make_loss_fn``/``make_device_metrics``: single task and verb/noun."""
    rng = _rng(sum(num_classes))
    jcfg, pcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, pcfg):
        cfg.MODEL.NUM_CLASSES = num_classes
        cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    preds = [rng.standard_normal((16, n)).astype(np.float32) for n in num_classes]
    names = ["class_id"] if len(num_classes) == 1 else ["verb", "noun"]
    labels = {k: rng.integers(0, n, 16) for k, n in zip(names, num_classes)}
    jpreds = jnp.asarray(preds[0]) if len(preds) == 1 else tuple(map(jnp.asarray, preds))
    tpreds = torch.from_numpy(preds[0]) if len(preds) == 1 else [torch.from_numpy(p)
                                                                for p in preds]
    jlab = {k: jnp.asarray(v) for k, v in labels.items()}
    tlab = {k: torch.from_numpy(v) for k, v in labels.items()}
    want_loss, want_parts = jax_steps.make_loss_fn(jcfg)(jpreds, jlab)
    got_loss, got_parts = steps.make_loss_fn(pcfg)(tpreds, tlab)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    assert set(got_parts) == set(want_parts)
    for k in want_parts:
        np.testing.assert_allclose(got_parts[k].item(), float(want_parts[k]), rtol=1e-6)
    want = jax_steps.make_device_metrics(jcfg)(jpreds, jlab)
    got = steps.make_device_metrics(pcfg)(tpreds, tlab)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_lr_policy_matches_jax_over_epochs():
    epochs = np.linspace(0.0, 40.0, 161)
    for policy, extra in [
        ("cosine", dict(WARMUP_EPOCHS=0.0)),
        ("cosine", dict(WARMUP_EPOCHS=3.5, WARMUP_START_LR=0.002, COSINE_END_LR=1e-4)),
        ("steps_with_relative_lrs", dict(STEPS=[0, 10, 25], LRS=[1, 0.1, 0.01])),
        ("steps_with_relative_lrs", dict(STEPS=[0, 10, 25], LRS=[1, 0.1, 0.01],
                                         WARMUP_EPOCHS=2.0)),
    ]:
        jcfg, pcfg = jax_get_cfg(), get_cfg()
        for cfg in (jcfg, pcfg):
            cfg.SOLVER.LR_POLICY = policy
            cfg.SOLVER.BASE_LR = 0.05
            cfg.SOLVER.MAX_EPOCH = 30
            for k, v in extra.items():
                setattr(cfg.SOLVER, k, v)
        for e in epochs:
            assert lr_policy.get_lr_at_epoch(pcfg, float(e)) == \
                jax_lr_policy.get_lr_at_epoch(jcfg, float(e))
    with pytest.raises(NotImplementedError):
        lr_policy.get_lr_func("exp")


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_variables():
    """Weights of the tiny SlowFast as JAX variables: drawn by the port's
    initialisers and carried over by the JAX package's own converter (no
    compile); the port loads them back through its ``convert.py``."""
    cfg = tiny(get_cfg())
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(3))
    variables = torch_state_to_flax({k: v.detach().clone() for k, v in model.state_dict().items()})
    return jax.tree.map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})


def _jax_leaf_names(params):
    """Dotted JAX names of the parameter tree, keyed by their torch names."""
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax_optim._path_str(path)
        prefix, leaf = name.rsplit(".", 1)
        torch_leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        out[f"{prefix}.{torch_leaf}"] = path
    return out


def _solver_cfg(cfg, method, freeze):
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.BASE_LR = 0.05
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    cfg.SOLVER.DAMPENING = 0.1
    cfg.SOLVER.WEIGHT_DECAY = 1e-2
    cfg.BN.WEIGHT_DECAY = 1e-3
    cfg.BN.FREEZE = freeze
    cfg.SOLVER.LR_POLICY = "cosine"
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.SOLVER.WARMUP_EPOCHS = 0.4
    cfg.SOLVER.WARMUP_START_LR = 0.002
    return cfg


@pytest.mark.parametrize("freeze", [False, True])
def test_param_groups_follow_the_jax_masks(tiny_variables, freeze):
    pcfg = _solver_cfg(tiny(get_cfg()), "sgd", freeze)
    pcfg.GPU.COMPUTE_DTYPE = "float32"
    model = build_model(pcfg, device="cpu")
    opt = optimizer.construct_optimizer(pcfg, model)
    names = {id(p): n for n, p in model.named_parameters()}
    groups = {g["name"]: {names[id(p)] for p in g["params"]} for g in opt.param_groups}
    jax_names = _jax_leaf_names(tiny_variables["params"])
    assert set(jax_names) == set(names.values())
    want_bn = {n for n, path in jax_names.items() if jax_optim.is_bn_param(path)}
    frozen = {n for n, path in jax_names.items() if jax_optim.is_frozen_bn_param(path)}
    assert want_bn and frozen < want_bn
    assert groups["bn"] == (want_bn - frozen if freeze else want_bn)
    assert groups["non_bn"] == set(jax_names) - want_bn
    if freeze:  # only the stems' and s1_fuse's BN keep moving
        assert all(n.startswith(("s1.", "s1_fuse.")) for n in groups["bn"])


@pytest.mark.parametrize("method,freeze", [("sgd", False), ("adam", False), ("sgd", True)])
def test_optimizer_trajectory_is_exact(tiny_variables, method, freeze):
    """Nesterov SGD with dampening 0.1 (its first step moves by (1 - 0.1) g,
    not torch.optim.SGD's g), Adam, the BN/non-BN decay split and BN.FREEZE:
    after N_STEPS injected gradients with the warm-up -> cosine LR, both
    sides' parameters agree to float32 rounding."""
    jcfg = _solver_cfg(tiny(jax_get_cfg()), method, freeze)
    pcfg = _solver_cfg(tiny(get_cfg()), method, freeze)
    pcfg.GPU.COMPUTE_DTYPE = "float32"

    params = jax.tree.map(jnp.asarray, tiny_variables["params"])
    tx = jax_optim.construct_optimizer(jcfg, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    model = build_model(pcfg, device="cpu")
    model.load_state_dict(flax_variables_to_torch_state(tiny_variables), strict=True)
    opt = optimizer.construct_optimizer(pcfg, model)
    named = dict(model.named_parameters())

    for it in range(N_STEPS):
        lr = lr_policy.get_lr_at_epoch(pcfg, it / N_STEPS)
        rng = _rng(100 + it)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                             tiny_variables["params"])
        opt_state = jax_optim.set_lr(opt_state, lr)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

        for k, g in flax_variables_to_torch_state({"params": grads}).items():
            named[k].grad = g
        optimizer.set_lr(opt, lr)
        opt.step()
        assert optimizer.get_lr(opt) == lr

    want = flax_variables_to_torch_state({"params": jax.tree.map(np.asarray, params)})
    init = flax_variables_to_torch_state(tiny_variables)
    moved = 0
    for k, w in want.items():
        got = named[k].detach()
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        moved += not torch.equal(got, init[k])
    frozen = sum(optimizer.is_frozen_bn_param(k) for k in want)
    assert moved == len(want) - (frozen if freeze else 0)


# --------------------------------------------------------------------------
# one whole train step
# --------------------------------------------------------------------------

def _step_cfg(cfg, freeze):
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.BN.FREEZE = freeze
    return cfg


def _batch(s):
    """Three clips; the short ones are zero past n_valid, so their log-mel
    frames repeat (edge replication) and the max-pool windows after the stems'
    ReLU hold ties, whose gradients both sides route to the first maximum."""
    rng = _rng(11)
    n_valid = np.asarray([s, s // 4, s // 2], np.int32)
    wave = (rng.standard_normal((3, s)) * 0.1).astype(np.float32)
    wave[np.arange(s)[None, :] >= n_valid[:, None]] = 0.0
    return wave, n_valid, rng.integers(0, 6, 3)


@pytest.mark.parametrize("freeze", [False, True])
def test_train_step_matches_jax(tiny_variables, freeze, monkeypatch):
    monkeypatch.setenv("ASF_MAXPOOL_SAS_BWD", "1")  # see the module docstring
    disable_tf32()
    jcfg = _step_cfg(tiny(jax_get_cfg()), freeze)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.USE_PALLAS_DSP = True  # K1 in interpret mode
    jcfg.TPU.DSP_PRECISION = "HIGHEST"
    jcfg.TPU.SPEC_AUGMENT = False
    pcfg = _step_cfg(tiny(get_cfg()), freeze)
    pcfg.GPU.COMPUTE_DTYPE = "float32"
    pcfg.GPU.SPEC_AUGMENT = False

    jmodel = jax_build_model(jcfg)
    tx = jax_optim.construct_optimizer(jcfg, tiny_variables["params"])
    jstate = jax_steps.TrainState(
        params=tiny_variables["params"], batch_stats=tiny_variables["batch_stats"],
        opt_state=tx.init(tiny_variables["params"]), step=jnp.zeros((), jnp.int32),
    )
    jstep = jax_steps.make_train_step(jcfg, jmodel, tx)

    step, (state, _) = train_entry(batch=3, dsp_precision="HIGHEST", device="cpu", cfg=pcfg)
    state.model.load_state_dict(flax_variables_to_torch_state(tiny_variables), strict=True)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}

    wave, n_valid, labels = _batch(step.pipeline.params.clip_samples)
    lr = 0.01
    jstate, jparts, jstats = jstep(
        jstate, {"waveform": jnp.asarray(wave), "n_valid": jnp.asarray(n_valid),
                 "labels": {"class_id": jnp.asarray(labels)}},
        jnp.float32(lr), jax.random.PRNGKey(0))
    parts, stats = step(state, {"waveform": torch.from_numpy(wave),
                                "n_valid": torch.from_numpy(n_valid),
                                "labels": {"class_id": torch.from_numpy(labels)}}, lr)
    assert state.step == 1 and optimizer.get_lr(state.optimizer) == lr

    # the loss is a forward: float32 in another summation order
    assert abs(parts["loss"].item() - float(jparts["loss"])) <= 2e-5
    assert set(stats) == set(jstats)
    for k in stats:  # XLA divides by the batch size as a product with 1/3: 1 ulp
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(parts["param_norm"].item(), float(jparts["param_norm"]),
                               rtol=1e-5)
    # gradients in float32 in another summation order: 4.6e-7 read here
    np.testing.assert_allclose(parts["grad_norm"].item(), float(jparts["grad_norm"]),
                               rtol=2e-6)

    want = flax_variables_to_torch_state({"params": jax.tree.map(np.asarray, jstate.params),
                                          "batch_stats": jax.tree.map(np.asarray,
                                                                      jstate.batch_stats)})
    got = state.model.state_dict()
    # the parameter update, in float64: 1 - cosine read 2e-11 (1e-12 frozen),
    # the norm ratio 1 + 2e-8 (4e-7 frozen)
    keys = [k for k in want if not k.endswith(("running_mean", "running_var",
                                               "num_batches_tracked"))]
    dg = torch.cat([(got[k] - init[k]).ravel() for k in keys]).double()
    dw = torch.cat([(want[k] - init[k]).ravel() for k in keys]).double()
    cos = torch.dot(dg, dw) / (dg.norm() * dw.norm())
    assert 1 - cos.item() <= 1e-10 and abs(dg.norm().item() / dw.norm().item() - 1) <= 2e-6
    # BN running statistics come from the forward
    n_stats = 0
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            n_stats += not torch.equal(got[k], init[k])
    if freeze:  # only the s1 stems' and s1_fuse's statistics move
        assert n_stats == 2 * 3
        for k in keys:
            if optimizer.is_frozen_bn_param(k):
                assert torch.equal(got[k], init[k]), k
    else:
        assert n_stats == sum(k.endswith(("running_mean", "running_var")) for k in want)


def test_step_gradients_match_float64(tiny_variables):
    """The port's float32 gradients on the tied batch, leaf by leaf, against
    the same model's in float64: the side that the JAX claim-chain pool
    disagrees with is right to float32 rounding (2.3e-6 read in the stems)."""
    disable_tf32()
    pcfg = tiny(get_cfg())
    pcfg.GPU.COMPUTE_DTYPE = "float32"
    pcfg.GPU.SPEC_AUGMENT = False
    step, (state, _) = train_entry(batch=3, dsp_precision="HIGHEST", device="cpu", cfg=pcfg)
    state.model.load_state_dict(flax_variables_to_torch_state(tiny_variables), strict=True)
    wave, n_valid, labels = _batch(step.pipeline.params.clip_samples)
    with torch.no_grad():
        paths = step.pipeline(torch.from_numpy(wave), torch.from_numpy(n_valid),
                              state.generator, train=True)
    m64 = copy.deepcopy(state.model).double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    grads = []
    for model, dtype in ((state.model.train(), torch.float32), (m64.train(), torch.float64)):
        losses.cross_entropy(model([p.to(dtype) for p in paths]),
                             torch.from_numpy(labels)).backward()
        grads.append({k: p.grad.double() for k, p in model.named_parameters()})
    g32, g64 = grads
    scale = torch.cat([g.ravel() for g in g64.values()]).norm()
    assert scale > 0
    for k, g in g64.items():  # leaves of near-zero gradient are held at 1e-6 of the whole
        err = (g32[k] - g).norm()
        assert err <= 1e-5 * g.norm() + 1e-6 * scale, (k, err.item(), g.norm().item())


def test_train_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry(batch=1)
