"""The train step: waveforms -> loss -> gradients -> optimizer update, on the device.

Counterparts of ``asf_tpu/engine/steps.py``: ``is_gru_model`` (:43),
``prepare_state_labels`` (``prepare_state_labels_jnp``, :131-143),
``make_loss_fn`` (:146-184), ``_apply_model`` (:187-199),
``make_device_metrics`` (:202-236), ``_make_step_core``/``make_train_step``
(:279-351), ``make_eval_step`` (:419-432) and ``init_state`` (:505-531).
The GRU model takes its chains' ``lengths``, ``noun_embedding`` and
``host_lengths`` beside the pathways; its loss and metrics are the
verb/noun ones, a row a chain. With the state head the loss is the mean of
the verb, noun and state losses, the state's over labels built on the
device from the chains' ``lengths`` (a single clip is one window holding
its postcondition), and the metrics add ``state_pred_max_abs``. The JAX
package's scanned K-step dispatch (:354-416) exists for XLA dispatch costs
and is not ported.

``watch_summary`` is ``asf_tpu/engine/steps.py:242-276``: a 64-bin
histogram and the range of each parameter and gradient, computed on the
card. A step built with ``watch=True`` adds it to its parts under
``"watch"`` every ``LOG_PERIOD`` steps (the JAX step's :315-335), where the
train loop reads it at its flush. ``train(cfg)`` builds it so only while a
W&B run is live (the JAX step computes it whenever ``WANDB.ENABLE`` and
drops it without a run).

One step is: the input pipeline with SpecAugment, the LR written into the
optimizer, the train-mode forward (BN running statistics update here), the
loss, ``backward``, the optimizer step, then ``grad_norm`` and
``param_norm`` (over every parameter, BN's included, the latter after the
update) and ``state.step + 1``; the spans ``step.frontend`` (the pipeline),
``step.forward`` (forward and loss), ``step.backward`` (``zero_grad`` and
``backward``), ``step.update`` (the optimizer step) and ``step.stats``
(metrics, rank reduction, norms, watch) cover it (``utils/spans.py``); an
eval step is ``step.frontend`` and ``step.forward``. Where a CUDA graph runs
the work after the front end (``engine/graphs.py``), ``step.replay`` takes
the place of the four spans after ``step.frontend`` (and of the eval step's
``step.forward``). Where the JAX step takes the state and
returns a new one (donating the old), this step updates ``state.model``,
``state.optimizer`` and ``state.step`` in place and returns ``(parts,
stats)``: loss parts and top-k statistics as 0-d tensors on the device, so
that the step never waits for the card.

In a process group the forward goes through ``state.ddp``, the
``DistributedDataParallel`` wrapper of ``state.model``, whose backward
averages the gradients over the data ranks (so the norms read the
average), and the loss parts and accuracies are averaged over the data
ranks on the device (``state_pred_max_abs`` takes their maximum): the
global-batch means that the JAX package's one program computes. The state
loss, a mean over the windows each rank keeps (their number differs
between ranks), divides its rank's sum by the count over the data ranks
over their number (``rank_divisor``), so that both averages give the
global mean. On a data x model grid (``GPU.MODEL_PARALLEL``,
``parallel/tensor.py``) a sharded leaf holds this rank's block: the norms
sum its squares over the model group and count each replicated leaf once,
and the watch histograms bin its block over the whole leaf's range and sum
its counts over the model group, so that they still add up to the leaf's
size.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..models import losses as losses_mod
from ..parallel import dist, tensor
from ..utils.spans import span
from . import graphs
from . import metrics as metrics_mod
from .optimizer import construct_optimizer, set_lr
from .pipeline import make_input_pipeline


def is_gru_model(cfg) -> bool:
    return cfg.MODEL.MODEL_NAME == "AudioSlowFastGRU"


def apply_model(cfg):
    """``forward(model, paths, batch) -> predictions``: the pathways alone,
    or for the GRU model with the batch's ``lengths``, ``noun_embedding``
    and ``host_lengths``."""
    if not is_gru_model(cfg):
        return lambda model, paths, batch: model(paths)

    def forward(model, paths, batch):
        return model(paths, batch["lengths"], batch.get("noun_embedding"),
                     host_lengths=batch.get("host_lengths"))

    return forward


def is_multitask(cfg) -> bool:
    return len(cfg.MODEL.NUM_CLASSES) > 1


def has_state_head(cfg) -> bool:
    return is_multitask(cfg) and not cfg.MODEL.ONLY_ACTION_RECOGNITION


def prepare_state_labels(precs: torch.Tensor, posts: torch.Tensor, lengths: torch.Tensor,
                         n_windows: int) -> torch.Tensor:
    """(B, N, P, 3) one-hot state labels of chains of ``lengths`` windows:
    the preconditions ``precs`` (B, P) in {-1, 0, 1} in the first half of
    each chain (windows below ``length // 2``), the postconditions ``posts``
    after, and -1 in every padded window (n >= length). Built where the
    tensors lie, with no read of their values on the host."""
    n_idx = torch.arange(n_windows, device=precs.device)[None, :, None]  # (1, N, 1)
    half = (lengths // 2)[:, None, None]
    state = torch.where(n_idx < half, precs[:, None, :], posts[:, None, :])  # (B, N, P)
    # one_hot of (state + 1) as an int: an index outside [0, 3) gives zeros
    classes = torch.arange(3, device=precs.device)
    one_hot = ((state + 1).long()[..., None] == classes).float()
    padded = (n_idx >= lengths[:, None, None])[..., None]
    return torch.where(padded, -1.0, one_hot)


def state_of(preds, lengths=None):
    """The state head's output as windows, (B, N, P, 3), and the chains'
    ``lengths``: a single clip's (B, P, 3) is one window (lengths None)."""
    x_s = preds[2]
    if x_s.dim() == 3:
        x_s = x_s[:, None]
    if lengths is None:
        lengths = torch.ones(x_s.shape[0], dtype=torch.int32, device=x_s.device)
    return x_s, lengths


def rank_divisor(count: torch.Tensor, ranks: int, group) -> torch.Tensor:
    """The divisor of a masked sum over this rank's rows whose mean over the
    ``ranks`` data ranks of ``group`` (the world when None) is the global
    batch's mean: ``max(count over them, 1) / ranks``, the count summed on
    the device (one ``all_reduce`` across ranks, none for one)."""
    if ranks == 1:
        return count.clamp(min=1)
    total = dist.all_reduce_sum(count.float().reshape(1), group)[0]
    return total.clamp(min=1) / ranks


def make_loss_fn(cfg):
    """``compute(preds, labels, lengths=None) -> (total_loss, dict of
    components)``; ``lengths`` (B,) are the chains' (the state head's
    labels; one window a clip when None)."""
    loss_fun = losses_mod.get_loss_func(cfg.MODEL.LOSS_FUNC)
    multitask = is_multitask(cfg)
    with_state = has_state_head(cfg)
    divisor = functools.partial(rank_divisor, ranks=dist.data_size(cfg),
                                group=dist.data_group(cfg))

    def compute(preds, labels, lengths=None):
        if not multitask:
            key = "class_id" if "class_id" in labels else "verb"
            loss = loss_fun(preds, labels[key])
            return loss, {"loss": loss}
        if with_state:
            x_s, lengths = state_of(preds, lengths)
            loss_verb = loss_fun(preds[0], labels["verb"])
            loss_noun = loss_fun(preds[1], labels["noun"])
            state_labels = prepare_state_labels(labels["precs"], labels["posts"], lengths,
                                                x_s.shape[1])
            loss_state = losses_mod.state_cross_entropy(x_s, state_labels, divisor)
            total = (loss_verb + loss_noun + loss_state) / 3.0
            return total, {"loss": total, "verb_loss": loss_verb, "noun_loss": loss_noun,
                           "state_loss": loss_state}
        loss_verb = loss_fun(preds[0], labels["verb"])
        loss_noun = loss_fun(preds[1], labels["noun"])
        total = (loss_verb + loss_noun) / 2.0
        return total, {"loss": total, "verb_loss": loss_verb, "noun_loss": loss_noun}

    return compute


def make_device_metrics(cfg):
    """Per-batch train accuracies on the step's predictions, left on the
    device; with the state head also ``state_pred_max_abs``, the largest
    |state logit|, which the "State looking strange" alert reads."""
    multitask = is_multitask(cfg)
    with_state = has_state_head(cfg)

    def compute(preds, labels):
        if multitask:
            x_v, x_n = preds[0], preds[1]
            v1, v5 = metrics_mod.topk_accuracies(x_v, labels["verb"], (1, 5))
            n1, n5 = metrics_mod.topk_accuracies(x_n, labels["noun"], (1, 5))
            a1, a5 = metrics_mod.multitask_topk_accuracies(
                (x_v, x_n), (labels["verb"], labels["noun"]), (1, 5)
            )
            out = {
                "verb_top1": v1, "verb_top5": v5,
                "noun_top1": n1, "noun_top5": n5,
                "action_top1": a1, "action_top5": a5,
            }
            if with_state:
                out["state_pred_max_abs"] = preds[2].float().abs().max()
            return out
        key = "class_id" if "class_id" in labels else "verb"
        k1, k5 = metrics_mod.topk_accuracies(preds, labels[key], (1, 5))
        return {"top1_err": 100.0 - k1, "top5_err": 100.0 - k5}

    return compute


def reduce_over_ranks(values: dict, group=None) -> dict:
    """0-d tensors averaged over the ranks of ``group``, the world when None
    (``state_pred_max_abs``: their maximum), with one ``all_gather`` and no
    read on the host."""
    names = list(values)
    ranks = dist.all_gather(torch.stack([values[k].float() for k in names]), group)  # (ranks, K)
    return {k: ranks[:, i].max() if k == "state_pred_max_abs" else ranks[:, i].mean()
            for i, k in enumerate(names)}


WATCH_BINS = 64


def watch_name(name: str, ndim: int) -> str:
    """The JAX tree path of parameter ``name``, joined by "/": a conv or
    dense ``weight`` is a ``kernel``, a norm's ``weight`` its ``scale``
    (the converter's names, ``checkpoint/convert.py``)."""
    *prefix, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return "/".join(prefix + [leaf])


@torch.no_grad()
def watch_summary(tensors: list, sharded=None,
                  shard: Optional[tensor.Shard] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts (L, 64) int64, ranges (L, 2) float32)`` of L tensors, on
    their device: each one's float32 values binned by the JAX package's rule,
    ``clip(int((x - lo) / max(hi - lo, 1e-12) * 64), 0, 63)`` over its
    ``[lo, hi]``, the bin edges ``linspace(lo, hi, 65)``. The counts are
    added with ``scatter_add_``, which reads nothing back to the host
    (``torch.bincount`` on CUDA reads its input's maximum to size its
    output). With a ``shard``, the tensors flagged in ``sharded`` are this
    rank's blocks: their ranges are taken over the model group and their
    counts summed over it (every rank of the group calls this alike)."""
    xs = [t.detach().float().reshape(-1) for t in tensors]
    ranges = [torch.stack(torch.aminmax(x)) for x in xs]
    rows = [] if shard is None else [i for i, f in enumerate(sharded) if f]
    if rows:  # each block's (-lo, hi), the maximum over the model group
        ends = dist.all_reduce_max(torch.stack([torch.stack([-ranges[i][0], ranges[i][1]])
                                                for i in rows]), shard.group)
        for j, i in enumerate(rows):
            ranges[i] = torch.stack([-ends[j, 0], ends[j, 1]])
    ranges = torch.stack(ranges)
    span = (ranges[:, 1] - ranges[:, 0]).clamp(min=1e-12)
    counts = torch.zeros(len(xs), WATCH_BINS, dtype=torch.int64, device=ranges.device)
    for i, x in enumerate(xs):
        idx = ((x - ranges[i, 0]) / span[i] * WATCH_BINS).to(torch.int32)
        idx = idx.clamp_(0, WATCH_BINS - 1).long()
        counts[i].scatter_add_(0, idx, torch.ones_like(idx))
    if rows:
        summed = dist.all_reduce_sum(torch.stack([counts[i] for i in rows]), shard.group)
        for j, i in enumerate(rows):
            counts[i] = summed[j]
    return counts, ranges


@dataclass
class TrainState:
    """What the step updates in place: the model (parameters and BN
    statistics), the optimizer, SpecAugment's generator and the step count;
    in a process group also ``ddp``, the model's ``DistributedDataParallel``
    wrapper, which the step's forward goes through."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    ddp: Optional[nn.Module] = None


def init_state(cfg, model: nn.Module) -> TrainState:
    """The optimizer of ``cfg`` over ``model``, and a SpecAugment generator
    seeded with 0 on the model's device (reseed ``state.generator`` for
    other draws)."""
    device = next(model.parameters()).device
    return TrainState(model=model, optimizer=construct_optimizer(cfg, model),
                      generator=torch.Generator(device=device).manual_seed(0))


def make_train_step(cfg, device, watch: bool = False):
    """``train_step(state, batch, lr) -> (parts, stats)``.

    ``batch`` holds ``waveform`` (B, S) float32 or int16, ``n_valid`` (B,)
    and ``labels`` (``class_id``, or ``verb`` and ``noun``, with the state
    head also ``precs`` and ``posts`` (B, P)) on ``device``; for the GRU
    model waveform (B, N, S), n_valid (B, N), ``lengths`` (B,),
    ``noun_embedding`` (B, 512) and ``host_lengths``.
    The model, optimizer and step count in ``state`` are updated in place.
    With ``watch``, a step whose count before it is a multiple of
    ``LOG_PERIOD`` adds ``parts["watch"] = (names, counts, ranges)``:
    ``watch_summary`` of every parameter after the update
    (``parameters/<path>``) and every gradient (``gradients/<path>``).

    Where ``graphs.engages`` (a single-clip batch on the card, one process,
    SGD), the work after the front end, from the forward to the norms, runs
    as a CUDA graph of the batch's signature (``engine/graphs.py``): the LR
    reaches it through the optimizer's LR tensors (``set_lr``), and the
    watch summary is computed eagerly after the replay.
    """
    pipeline = make_input_pipeline(cfg, device)
    forward = apply_model(cfg)
    loss_fn = make_loss_fn(cfg)
    device_metrics = make_device_metrics(cfg)
    watch_period = max(1, int(cfg.LOG_PERIOD))
    data_group, shard = dist.data_group(cfg), tensor.model_shard(cfg)
    step_graphs = graphs.StepGraphs()

    def core(model, net, optimizer, paths, batch):
        """The step after the front end, eager or captured: forward, loss,
        backward, update and statistics."""
        with span("step.forward"):
            preds = forward(net, paths, batch)
            loss, parts = loss_fn(preds, batch["labels"], batch.get("lengths"))
        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("step.update"):
            optimizer.step()
        with span("step.stats"), torch.no_grad():
            params = [p for p in model.parameters() if p.grad is not None]
            parts = {k: v.detach() for k, v in parts.items()}
            stats = device_metrics(preds, batch["labels"])
            if dist.is_initialized():
                reduced = reduce_over_ranks({**parts, **stats}, data_group)
                parts = {k: reduced[k] for k in parts}
                stats = {k: reduced[k] for k in stats}
            everything = list(model.parameters())
            parts["grad_norm"] = tensor.global_norm((p.grad for p in params),
                                                    map(tensor.is_sharded, params), shard)
            parts["param_norm"] = tensor.global_norm(everything,
                                                     map(tensor.is_sharded, everything), shard)
        return parts, stats

    def train_step(state: TrainState, batch: dict, lr: float):
        model, optimizer = state.model, state.optimizer
        net = model if state.ddp is None else state.ddp
        # train() walks every module on the host: before the front end, so
        # that the walk overlaps the card's work
        net.train()
        paths = pipeline(batch["waveform"], batch["n_valid"], state.generator, train=True)
        set_lr(optimizer, lr)
        rest = functools.partial(core, model, net, optimizer)
        if graphs.engages(paths[0].device, batch, optimizer):
            owner = (model, optimizer, optimizer.state, optimizer.param_groups)
            batch = graphs.after_frontend(batch)
            parts, stats = step_graphs.run(owner, graphs.signature(paths, batch, True), rest,
                                           paths, batch, model.parameters())
        else:
            parts, stats = rest(paths, batch)
        if watch and state.step % watch_period == 0:
            with span("step.stats"):
                named = list(model.named_parameters())
                graded = [(n, p) for n, p in named if p.grad is not None]
                names = ([f"parameters/{watch_name(n, p.dim())}" for n, p in named]
                         + [f"gradients/{watch_name(n, p.dim())}" for n, p in graded])
                leaves = [p for _, p in named] + [p for _, p in graded]
                parts["watch"] = (names, *watch_summary(
                    [p for _, p in named] + [p.grad for _, p in graded],
                    map(tensor.is_sharded, leaves), shard))
        state.step += 1
        return parts, stats

    train_step.pipeline = pipeline
    return train_step


def make_eval_step(cfg, device):
    """``eval_step(model, batch) -> probabilities``: the input pipeline
    without augmentation, then the model in eval mode (softmax, then the
    mean over positions), under ``torch.inference_mode()``; where
    ``graphs.engages``, the forward runs as a CUDA graph of the batch's
    signature and the probabilities come back cloned."""
    pipeline = make_input_pipeline(cfg, device)
    forward = apply_model(cfg)
    step_graphs = graphs.StepGraphs()

    @torch.inference_mode()
    def eval_step(model: nn.Module, batch: dict):
        model.eval()  # before the front end, as in train_step
        paths = pipeline(batch["waveform"], batch["n_valid"], train=False)

        def rest(paths, batch):
            with span("step.forward"):
                return forward(model, paths, batch)

        if graphs.engages(paths[0].device, batch):
            batch = graphs.after_frontend(batch, graphs.EVAL_READS)
            return step_graphs.run((model,), graphs.signature(paths, batch, False), rest,
                                   paths, batch)
        return rest(paths, batch)

    return eval_step
