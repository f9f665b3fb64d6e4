"""The port's three batch-norm types in one process against ``asf_tpu``'s ``TorchBatchNorm``.

The same seeded numpy inputs (NCHW for the port, NHWC for the JAX package)
go through ``asf_tpu_torch.models.norm.make_norm`` and through
``asf_tpu.models.norm.TorchBatchNorm`` with the split count and running
variance that ``asf_tpu``'s ``make_norm`` gives each type: ``batchnorm``
(one split, unbiased), ``sub_batchnorm`` with ``NUM_SPLITS`` 2 and 4 (its
splits, unbiased with the count of one split) and ``sync_batchnorm`` at
world size 1 (one split, biased). Float32, within 1e-5: the output, the
running statistics after two steps, the input and parameter gradients,
``MOMENTUM_OVERRIDE``, precise BN's cumulative average, ``BN.FREEZE`` with
its exemption, and a silent channel, where the port's two-pass variance
stays with float64 and ``asf_tpu``'s one-pass one does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.models import build_model as jax_build_model
from asf_tpu.models.norm import TorchBatchNorm
from asf_tpu_torch.checkpoint.convert import flax_variables_to_torch_state
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.models import build_model
from asf_tpu_torch.models.norm import BatchNorm2d, GroupedBatchNorm2d, make_norm
from test_torch_port_model import tiny

TOL = 1e-5
# The silent channel's output in float32: its mean (13.8) rounds by up to
# 1e-6, and 1 / sqrt(var + eps) ~ 300 there carries that into the output.
SILENT_OUT = 5e-4
# Its variance, 1e-6, within 1e-3 of itself: the float32 split means, rounded
# by up to 5e-7, enter the between-split term through a difference of ~3e-4.
SILENT_VAR = 1e-9
C = 6
# (BN.NORM_TYPE, BN.NUM_SPLITS): the JAX side's splits and running variance follow.
CASES = [("batchnorm", 1), ("sub_batchnorm", 2), ("sub_batchnorm", 4), ("sync_batchnorm", 1)]
IDS = ["batchnorm", "sub2", "sub4", "sync-world1"]


def _cfg(norm_type, splits, **bn):
    cfg = get_cfg()
    cfg.BN.NORM_TYPE = norm_type
    cfg.BN.NUM_SPLITS = splits
    for k, v in bn.items():
        cfg.BN[k] = v
    return cfg


def _jax_bn(norm_type, splits, momentum=0.1):
    return TorchBatchNorm(features=C, momentum=momentum,
                          num_splits=splits if norm_type == "sub_batchnorm" else 1,
                          unbiased_running=norm_type != "sync_batchnorm")


def _inputs(seed, n=8, silent=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C, 5, 4)) * 2 + rng.uniform(-3, 3, (1, C, 1, 1))
    x = x.astype(np.float32)
    if silent:  # channel 0: a silent record's log-mel, log(1e-6), a hair of noise on it
        noise = rng.standard_normal((n, 5, 4)).astype(np.float32) * 1e-3
        x[:, 0] = np.float32(np.log(1e-6)) + noise
    return x, rng.standard_normal(x.shape).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _params(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, C).astype(np.float32),
            rng.standard_normal(C).astype(np.float32) * 0.1)


def _jax_step(bn, params, stats, x, t):
    """Output, new statistics and the gradients of ``sum(y * t)``."""
    def loss(p, xj):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xj, use_running_average=False,
                          mutable=["batch_stats"])
        return (y * _nhwc(t)).sum(), (y, upd["batch_stats"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, _nhwc(x))
    return y, new, gp, gx


def _port(cfg, w, b, freeze_exempt=False):
    m = make_norm(cfg)(C, freeze_exempt=freeze_exempt)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        m.bias.copy_(torch.from_numpy(b))
    return m.train()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("norm_type,splits", CASES, ids=IDS)
def test_forward_statistics_and_gradients_match_jax(norm_type, splits):
    """Two train steps: each output, the input and parameter gradients of
    the first, and the running statistics after both."""
    w, b = _params(0)
    m = _port(_cfg(norm_type, splits), w, b)
    assert type(m) is (BatchNorm2d if norm_type == "batchnorm" else GroupedBatchNorm2d)
    bn = _jax_bn(norm_type, splits)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}
    for step in range(2):
        x, t = _inputs(step + 1)
        yj, stats, gp, gx = _jax_step(bn, params, stats, x, t)
        xt = torch.from_numpy(x).requires_grad_(True)
        m.weight.grad = m.bias.grad = None
        y = m(xt)
        (y * torch.from_numpy(t)).sum().backward()
        _close(y.detach(), _nchw(yj))
        if step == 0:
            _close(xt.grad, _nchw(gx))
            _close(m.weight.grad, gp["scale"])
            _close(m.bias.grad, gp["bias"])
    _close(m.running_mean, stats["mean"])
    _close(m.running_var, stats["var"])
    assert int(m.num_batches_tracked) == 2


@pytest.mark.parametrize("norm_type,splits", CASES, ids=IDS)
def test_momentum_override_and_precise_bn_match_jax(norm_type, splits):
    """``BN.MOMENTUM_OVERRIDE`` 1.0: the running statistics are the batch's,
    as in the JAX package's precise-BN step; precise BN (``momentum=None``
    after ``reset_running_stats``) keeps the mean of those over batches,
    what ``asf_tpu``'s precise BN averages."""
    w, b = _params(1)
    m = _port(_cfg(norm_type, splits, MOMENTUM_OVERRIDE=1.0), w, b)
    assert m.momentum == 1.0
    bn = _jax_bn(norm_type, splits, momentum=1.0)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    batch_stats = []
    for seed in (3, 4, 5):
        x, t = _inputs(seed)
        _, new, _, _ = _jax_step(bn, params, {"mean": jnp.zeros(C), "var": jnp.ones(C)}, x, t)
        batch_stats.append(new)
        with torch.no_grad():
            m(torch.from_numpy(x))
        _close(m.running_mean, new["mean"])
        _close(m.running_var, new["var"])
    m.reset_running_stats()
    m.momentum = None
    with torch.no_grad():
        for seed in (3, 4, 5):
            m(torch.from_numpy(_inputs(seed)[0]))
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        _close(getattr(m, name), np.mean([np.asarray(s[k]) for s in batch_stats], axis=0))


@pytest.mark.parametrize("norm_type,splits", CASES, ids=IDS)
def test_frozen_norm_uses_its_running_statistics_and_the_stem_stays_live(norm_type, splits):
    """``BN.FREEZE``: in train mode the output is ``asf_tpu``'s with
    ``use_running_average``, the statistics stay as they are; a
    freeze-exempt norm (the stems, ``s1_fuse``) still updates them."""
    w, b = _params(2)
    cfg = _cfg(norm_type, splits, FREEZE=True)
    frozen, live = _port(cfg, w, b), _port(cfg, w, b, freeze_exempt=True)
    rng = np.random.default_rng(9)
    mean, var = rng.standard_normal(C).astype(np.float32), rng.uniform(0.5, 2, C).astype(np.float32)
    for m in (frozen, live):
        m.running_mean.copy_(torch.from_numpy(mean))
        m.running_var.copy_(torch.from_numpy(var))
    x, t = _inputs(6)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    want = _jax_bn(norm_type, splits).apply(variables, _nhwc(x), use_running_average=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = frozen(xt)
    (y * torch.from_numpy(t)).sum().backward()
    _close(y.detach(), _nchw(want))
    assert torch.equal(frozen.running_mean, torch.from_numpy(mean))
    assert torch.equal(frozen.running_var, torch.from_numpy(var))
    assert frozen.weight.grad is not None and xt.grad is not None
    with torch.no_grad():
        live(torch.from_numpy(x))
    assert not torch.equal(live.running_mean, torch.from_numpy(mean))


@pytest.mark.parametrize("norm_type,splits", CASES, ids=IDS)
def test_silent_channel_stays_with_float64(norm_type, splits):
    """A channel whose mean (log(1e-6) = -13.8) dwarfs its spread (1e-3):
    the port's running variance (1e-6) within ``SILENT_VAR`` of float64 over
    the batch, and its output within ``SILENT_OUT`` of float64 and nearer to
    it than ``asf_tpu``'s (whose one-pass variance cancels to noise there,
    3e-5 off, at times below zero: NaN); the other channels within 1e-5 of
    ``asf_tpu``."""
    w, b = _params(3)
    m = _port(_cfg(norm_type, splits, MOMENTUM_OVERRIDE=1.0), w, b)
    x, t = _inputs(7, silent=True)
    with torch.no_grad():
        y = m(torch.from_numpy(x)).numpy()
    s = splits if norm_type == "sub_batchnorm" else 1
    x64 = x.astype(np.float64).reshape(s, -1, C, 20)
    mean, var = x64.mean(axis=(1, 3)), x64.var(axis=(1, 3))  # (splits, C)
    want = ((x64 - mean[:, None, :, None]) / np.sqrt(var[:, None, :, None] + 1e-5)
            * w[:, None] + b[:, None]).reshape(x.shape)
    agg = var.mean(axis=0) + ((mean - mean.mean(axis=0)) ** 2).mean(axis=0)
    if norm_type != "sync_batchnorm":
        n = x64.shape[1] * x64.shape[3]
        agg = agg * n / (n - 1)
    bn = _jax_bn(norm_type, splits, momentum=1.0)
    yj, stats, _, _ = _jax_step(bn, {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                                {"mean": jnp.zeros(C), "var": jnp.ones(C)}, x, t)
    _close(y[:, 1:], _nchw(yj)[:, 1:])
    _close(m.running_var[1:], stats["var"][1:])
    port_err = np.abs(y[:, 0] - want[:, 0]).max()
    jax_err = np.abs(_nchw(yj)[:, 0] - want[:, 0]).max()
    print(f"silent channel, |error| against float64: running var port "
          f"{abs(float(m.running_var[0]) - agg[0]):.3g}, asf_tpu "
          f"{abs(float(stats['var'][0]) - agg[0]):.3g}; output port {port_err:.3g}, "
          f"asf_tpu {jax_err:.3g}")
    assert abs(float(m.running_var[0]) - agg[0]) <= SILENT_VAR
    assert port_err <= SILENT_OUT
    assert not jax_err <= port_err  # NaN on the JAX side counts as farther


def test_a_rank_batch_the_splits_do_not_divide_raises():
    m = _port(_cfg("sub_batchnorm", 4), *_params(0))
    with pytest.raises(ValueError, match="not divisible"):
        m(torch.zeros(6, C, 2, 2))


@pytest.mark.parametrize("norm_type,splits", CASES, ids=IDS)
def test_each_type_converts_from_flax_and_loads_strictly(norm_type, splits):
    """A tiny ``asf_tpu`` model of each type (its variables' shapes, by
    ``jax.eval_shape``, filled from a seed) converts with
    ``flax_variables_to_torch_state`` and loads into the port's model of
    that type with ``strict=True``: the leaves keep their names."""
    jcfg, pcfg = tiny(jax_get_cfg()), tiny(get_cfg())
    for cfg in (jcfg, pcfg):
        cfg.BN.NORM_TYPE = norm_type
        cfg.BN.NUM_SPLITS = splits
    jcfg.TPU.DATA_PARALLEL = 1
    xs = [jnp.zeros((2, 16, 32, 1)), jnp.zeros((2, 64, 32, 1))]
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), xs, train=False))
    rng = np.random.default_rng(4)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    port = build_model(pcfg, "cpu")
    port.load_state_dict(flax_variables_to_torch_state(variables), strict=True)
    want = type(port.s1.pathway0_stem.bn)
    assert want is (BatchNorm2d if norm_type == "batchnorm" else GroupedBatchNorm2d)
    assert all(type(mod) is want for mod in port.modules() if isinstance(mod, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("norm_type,splits", CASES[1:], ids=IDS[1:])
def test_a_float64_grouped_norm_computes_in_float64(norm_type, splits):
    """A float64 model's grouped norm keeps float64 throughout: its output
    and its input and parameter gradients within 1e-12 of plain float64
    tensor ops (autograd) on the same splits."""
    x, t = (torch.from_numpy(a).double() for a in _inputs(7))
    w, b = _params(8)
    m = _port(_cfg(norm_type, splits), w, b).double()
    xa = x.clone().requires_grad_(True)
    y = m(xa)
    (y * t).sum().backward()
    assert y.dtype == torch.float64

    xr = x.clone().requires_grad_(True)
    wr, br = (torch.from_numpy(a).double().requires_grad_(True) for a in (w, b))
    xs = xr.reshape(splits, x.shape[0] // splits, C, -1)
    mean = xs.mean(dim=(1, 3), keepdim=True)
    var = ((xs - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    want = ((xs - mean) / torch.sqrt(var + 1e-5) * wr[:, None] + br[:, None]).reshape(x.shape)
    (want * t).sum().backward()
    for got, ref in ((y, want), (xa.grad, xr.grad), (m.weight.grad, wr.grad),
                     (m.bias.grad, br.grad)):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-12,
                                   atol=1e-12)
