"""The reference's training steps and eval scores.

A training step: the int16 samples scaled by 1 / 32768, the log-mel, SpecAugment
(drawn from ``spec_gen``), the pathways, the model in training mode with the
head's dropout mask given, the mean cross-entropy of verb and of noun, their
mean as the loss, the gradients, then SGD as the upstream solver configures it:
``d = g + wd * p`` (``wd`` = SOLVER.WEIGHT_DECAY, or BN.WEIGHT_DECAY for a norm's
leaves), ``buf = momentum * buf + (1 - dampening) * d`` from a zero buffer,
``d = d + momentum * buf`` with Nesterov, ``p = p - lr * d``; the frozen norms'
leaves are not updated.

``half_batch`` (a planted fault) takes the loss over the first half of the
rows alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import frontend, slowfast


def trainable(name: str) -> bool:
    """In the optimizer: every leaf but a frozen norm's scale and shift."""
    if name.rsplit(".", 1)[1] in ("running_mean", "running_var", "num_batches_tracked"):
        return False
    return "bn" not in name or any(name.startswith(b + ".") for b in slowfast.LIVE_BN)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back."""
    return t.to(torch.bfloat16).to(t.dtype)


def frontend_quant(quant, m: dict):
    """The control's front end, one precision below the configuration's:
    bfloat16 under a float32 front end, the trunk's ``quant`` under a bf16 one."""
    if quant is None:
        return None
    return quant if m["dsp_bf16"] else bf16


def inputs(batch: dict, m: dict, logmel, spec_gen, train: bool, quant=None):
    """The pathways of a batch: ``wave`` (R, S) int16, ``n_valid`` (R,)."""
    wave = batch["wave"].float() / 32768.0
    spec = logmel(wave, batch["n_valid"], frontend_quant(quant, m))
    if train:
        spec = frontend.spec_augment(spec, spec_gen)
    return frontend.pathways(spec, m["alpha"])


def train(weights: dict, batches: list, m: dict, solver: dict, spec_seed: int, mask,
          quant=None, half_batch: bool = False) -> dict:
    """Runs ``len(batches)`` steps from ``weights`` (float32, on the device).

    Each batch: ``wave`` (R, S) int16 tensor, ``n_valid`` (R,), ``verb`` and
    ``noun`` (B,), and for chains ``chains`` = (B, N) and ``lengths``.
    ``mask(shape)`` draws a step's dropout mask (0 or 1 / (1 - p)); the
    steps draw theirs in order.
    Returns each step's loss, the first step's gradients and the parameters
    after the last step."""
    device = next(iter(weights.values())).device
    p = {k: v.clone() for k, v in weights.items()}
    names = [k for k in p if trainable(k)]
    bufs = {k: torch.zeros_like(p[k]) for k in names}
    logmel = frontend.LogMel(m, device)
    gen = torch.Generator(device=device).manual_seed(int(spec_seed))
    losses, grads1 = [], None
    for k, batch in enumerate(batches):
        leaves = {n: p[n].detach().requires_grad_(
            not n.endswith(("running_mean", "running_var", "num_batches_tracked")))
            for n in p}
        paths = inputs(batch, m, logmel, gen, True, quant)
        ctx = slowfast.Ctx(leaves, train=True, quant=quant, dropout_mask=mask)
        verb, noun = slowfast.forward(ctx, paths, m, batch.get("chains"), batch.get("lengths"))
        rows = slice(0, verb.shape[0] // 2) if half_batch else slice(None)
        loss = (F.cross_entropy(verb[rows], batch["verb"][rows])
                + F.cross_entropy(noun[rows], batch["noun"][rows])) / 2.0
        graded = [n for n in leaves if leaves[n].requires_grad]
        g = dict(zip(graded, torch.autograd.grad(loss, [leaves[n] for n in graded])))
        if k == 0:
            grads1 = {n: g[n].detach().clone() for n in graded}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n in names:
                wd = solver["bn_weight_decay"] if "bn" in n else solver["weight_decay"]
                d = g[n] + wd * p[n]
                bufs[n] = solver["momentum"] * bufs[n] + (1.0 - solver["dampening"]) * d
                d = d + solver["momentum"] * bufs[n] if solver["nesterov"] else bufs[n]
                p[n] = p[n] - solver["lr"] * d
    return {"losses": losses, "grads1": grads1, "params": {n: p[n] for n in names}}


@torch.no_grad()
def eval_scores(weights: dict, batch: dict, m: dict, quant=None) -> tuple:
    """Each view's verb and noun probabilities (softmax, mean over positions)."""
    logmel = frontend.LogMel(m, next(iter(weights.values())).device)
    paths = inputs(batch, m, logmel, None, False, quant)
    return slowfast.forward(slowfast.Ctx(weights, train=False, quant=quant), paths, m)


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` in ``dtype`` under a per-tensor scale (its largest magnitude to
    ``largest``), and back."""
    scale = t.abs().amax().clamp(min=1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the input rounded to float8 e4m3; backward: the incoming
    gradient rounded to float8 e5m2 (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """The precision below bf16 at a product's input: float8 e4m3 values
    forward, float8 e5m2 gradients backward."""
    return _Fp8.apply(t) if t.requires_grad else _round(t, torch.float8_e4m3fn, 448.0)
