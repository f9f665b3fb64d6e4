"""Weights drawn from the run's seed, on the device, in a few large calls.

Every leaf of the model (``reference.slowfast.param_shapes``) comes from one
normal and one uniform draw of a ``torch.Generator`` on the device, sliced and
scaled, in float32:

* convolutions: normal, std sqrt(2 / fan_out) (Caffe2's MSRA fill, the
  upstream initialiser);
* linear layers: normal, std 0.01 (``MODEL.FC_INIT_STD``), bias normal std 0.01;
* GRU: uniform in +-1 / sqrt(H) (``nn.GRU``'s initialiser);
* batch norm: scale uniform in [0.5, 1], the last norm of each residual
  branch in [0.1, 0.4] (a trained ResNet's small final scales), shift normal
  std 0.05; running statistics are then set by ``calibrate``: one forward of
  the plain model over a batch of the run's audio in which every norm takes
  its batch's mean and variance as its running statistics, layer after layer,
  so that a frozen norm normalises what reaches it, as a trained network's
  does.

The same dict of weights is loaded into the program and handed to the plain
reference; neither derives it from the other.
"""

from __future__ import annotations

import math

import torch

from .reference import frontend, slowfast


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[1]
    if leaf == "num_batches_tracked":
        return "count"
    if ".gru." in name:
        return "gru"
    if leaf in ("running_mean", "running_var"):
        return "stat"
    if "_bn." in name or name.endswith(".bn.weight") or name.endswith(".bn.bias"):
        return "bn_final" if (leaf == "weight" and ".c_bn." in name) else f"bn_{leaf}"
    if len(shape) == 4:
        return "conv"
    return "linear"


def draw(m: dict, seed: int, device) -> dict:
    """The weights of the model of numbers ``m`` from ``seed``, on ``device``."""
    shapes = slowfast.param_shapes(m)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    normal = [n for n in shapes if kinds[n] in ("conv", "linear", "bn_bias")]
    uniform = [n for n in shapes if kinds[n] in ("gru", "bn_weight", "bn_final")]
    sizes = {n: math.prod(shapes[n]) for n in shapes}
    z = torch.randn(sum(sizes[n] for n in normal), generator=gen, device=device)
    u = torch.rand(sum(sizes[n] for n in uniform), generator=gen, device=device)
    out, off = {}, 0
    for n in normal:
        t = z[off:off + sizes[n]].view(shapes[n])
        off += sizes[n]
        if kinds[n] == "conv":
            o, _i, kt, kf = shapes[n]
            out[n] = t * math.sqrt(2.0 / (o * kt * kf))
        else:
            out[n] = t * (0.01 if kinds[n] == "linear" else 0.05)
    off = 0
    for n in uniform:
        t = u[off:off + sizes[n]].view(shapes[n])
        off += sizes[n]
        if kinds[n] == "gru":
            bound = 1.0 / math.sqrt(m["gru_hidden"])
            out[n] = (2.0 * t - 1.0) * bound
        elif kinds[n] == "bn_final":
            out[n] = 0.1 + 0.3 * t
        else:
            out[n] = 0.5 + 0.5 * t
    for n, k in kinds.items():
        if k == "stat":
            fill = 0.0 if n.endswith("running_mean") else 1.0
            out[n] = torch.full(shapes[n], fill, device=device)
        elif k == "count":
            out[n] = torch.zeros((), dtype=torch.int64, device=device)
    return {n: out[n].contiguous() for n in shapes}


@torch.no_grad()
def calibrate(weights: dict, m: dict, wave: torch.Tensor, n_valid: torch.Tensor) -> None:
    """Sets every norm's running statistics from one batch (``wave`` (B, S)
    float32 in [-1, 1), ``n_valid`` (B,)), in place, through the plain model."""
    spec = frontend.LogMel(m, wave.device)(wave, n_valid)
    ctx = slowfast.Ctx(weights, train=False, calibrate=True)
    slowfast.trunk(ctx, frontend.pathways(spec, m["alpha"]), m)
