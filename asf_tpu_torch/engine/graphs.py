"""A step's work after the front end as CUDA graphs, one per batch signature.

The train step's forward, loss, backward, SGD update and statistics, and the
eval step's forward, launch about a thousand small kernels a batch, one call
at a time; on the card the host's dispatch of them takes longer than the
card takes to run them. ``StepGraphs`` captures that work once as a
``torch.cuda.CUDAGraph`` and replays it for every later batch of the same
signature, so that the host sends one launch where it sent a thousand. The
front end (``engine/pipeline.py``) stays eager: its log-mel kernel keeps its
own launch, and SpecAugment draws from its own generator, which no graph
registers.

* ``signature(paths, batch, train)``: the shapes and dtypes of the pathways
  and of every tensor in ``batch`` (nested dicts), and the train flag; the
  batch as the graph reads it, ``after_frontend(batch)``: only the keys that
  the work after the front end reads, so that a replay copies no other.
* ``engages(device, batch, optimizer)``: what the step can observe decides
  whether a graph may run it, and nothing else: the device is CUDA, the
  batch carries no ``host_lengths`` (the GRU packs each batch's chains by
  their lengths on the host, so its launches differ from batch to batch),
  no process group is initialised (a graph would have to capture the
  collectives), and the optimizer, where there is one, is ``graphable``
  (its rule reads no host value that changes from step to step: SGD is,
  Adam's step count is not).
* ``StepGraphs.run``: the first batch of a signature runs eagerly (it also
  makes the optimizer's state and cuDNN's lazy state), the second captures
  the graph and replays it, every later one replays it. The graphs belong
  to an owner, a tuple of objects compared by identity (the model, the
  optimizer, its state and its param groups); another owner drops them all,
  as after a resume that rebuilt the optimizer. In-place updates
  (``load_state_dict`` of a model, precise BN) keep every address and need
  nothing.
* ``Graph``: the captured call. Its inputs are static tensors, into which
  each replay copies the batch's own; its outputs are cloned out after each
  replay, so that no later replay overwrites what a caller still holds (the
  train loop reads a step's numbers up to ``LOG_PERIOD`` steps later). With
  ``params``, each parameter's ``.grad`` is bound again after a replay to
  the graph's gradient, where an eager step in between gave it another
  tensor.

Dropout draws from the default CUDA generator, which a replay advances as
the eager step does, so a graphed step draws the eager step's masks. The
capture runs in ``thread_local`` mode: the prefetcher's thread keeps
copying batches to the card meanwhile, on its own stream. It must never be
the capture's stream, or the capture would take in the prefetcher's copies
and events: torch hands out its streams round-robin from a pool of 32 a
priority, and every prefetcher draws one of default priority, so a capture
on such a stream (torch's own capture stream is one) meets a prefetcher's
after 32 of them. So every capture runs on ``capture_stream(device)``, one
stream of the high-priority pool, which no prefetcher draws from. The spans
``step.capture`` and ``step.replay`` (``utils/spans.py``) time the capture
and each replay with its copies.
"""

from __future__ import annotations

import torch

from ..parallel import dist
from ..utils.spans import span


def _leaves(tree, prefix: str = ""):
    """(dotted key, tensor) of every tensor in a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def _map(tree, fn):
    """``fn`` applied to every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


# What the work after the front end reads of a batch: the loss's and the
# metrics' labels, and the GRU's chain lengths and h0 (``steps.apply_model``).
TRAIN_READS = ("labels", "lengths", "noun_embedding")
EVAL_READS = ("lengths", "noun_embedding")


def after_frontend(batch: dict, reads=TRAIN_READS) -> dict:
    return {k: batch[k] for k in reads if k in batch}


def signature(paths, batch: dict, train: bool) -> tuple:
    return (bool(train), tuple((tuple(p.shape), p.dtype) for p in paths),
            tuple((k, tuple(t.shape), t.dtype) for k, t in _leaves(batch)))


_capture_streams: dict = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` runs on (the module's docstring)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device, priority=-1)
    return _capture_streams[device]


def engages(device, batch: dict, optimizer=None) -> bool:
    return (torch.device(device).type == "cuda" and batch.get("host_lengths") is None
            and not dist.is_initialized()
            and (optimizer is None or getattr(optimizer, "graphable", False)))


class Graph:
    """``fn(paths, batch)`` captured on static copies of ``paths`` and of
    ``batch``'s tensors; ``replay(paths, batch)`` copies the new ones in,
    replays, and returns the outputs cloned."""

    def __init__(self, fn, paths, batch: dict, params=None):
        self.paths = [p.clone() for p in paths]
        self.batch = _map(batch, torch.Tensor.clone)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=capture_stream(self.paths[0].device),
                              capture_error_mode="thread_local"):
            self.out = fn(self.paths, self.batch)
        self.grads = [] if params is None else [(p, p.grad) for p in params
                                                if p.grad is not None]

    def replay(self, paths, batch: dict):
        for dst, src in zip(self.paths, paths):
            dst.copy_(src)
        for (_, dst), (_, src) in zip(_leaves(self.batch), _leaves(batch)):
            dst.copy_(src)
        self.graph.replay()
        for p, g in self.grads:
            if p.grad is not g:
                p.grad = g
        return _map(self.out, torch.Tensor.clone)


class StepGraphs:
    """The graphs of one step function, by signature, for one owner."""

    def __init__(self):
        self.owner: tuple = ()
        self.seen: set = set()
        self.graphs: dict = {}

    def run(self, owner: tuple, key: tuple, fn, paths, batch: dict, params=None):
        """``fn(paths, batch)``: eagerly on the first batch of ``key``, else
        through its graph (captured on the second)."""
        if len(owner) != len(self.owner) or any(a is not b for a, b in zip(owner, self.owner)):
            self.owner, self.seen, self.graphs = owner, set(), {}
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen:
                self.seen.add(key)
                return fn(paths, batch)
            with span("step.capture"):
                graph = self.graphs[key] = Graph(fn, paths, batch, params)
        with span("step.replay"):
            return graph.replay(paths, batch)
