"""The bidirectional GRU and the GRU sequence head.

Counterpart of ``asf_tpu/models/gru.py``. ``TorchGRU`` there is a masked
``lax.scan`` that reproduces torch's packed-sequence semantics with static
shapes (each reverse direction reversed within its length, padded outputs
zeroed); here it is what it reproduces: ``nn.GRU`` (cuDNN's on the card)
over a packed batch, then ``pad_packed_sequence(total_length=N)``, which
leaves zeros at the padded positions. Packing reads the lengths on the
host: the caller passes them as ``host_lengths`` (the prefetcher keeps
them). ``run_gru`` sorts the chains by length on the host and packs them
sorted, which is what ``pack_padded_sequence(enforce_sorted=False)`` does
inside; done there, that copies its sort order to the card with a blocking
copy and its inverse back with ``.cpu()``, and each makes the host wait for
the card. Here both orders go to the card as asynchronous copies, and the
step never waits. The parameters are ``nn.GRU``'s
(``weight_ih_l{k}[_reverse]``, ``weight_hh_...``, ``bias_ih_...``,
``bias_hh_...``; gate order r, z, n), the layout the JAX package stores, so
its leaves convert as they are.

The GRU computes in float32 under every compute dtype: cuDNN runs no bf16
RNN (PyTorch would fall back to a cell a time step), and the JAX package
keeps h in float32 too (only its input products and gates run in bf16).
The projections around it follow the compute dtype, as the other heads do.

``GRUResNetBasicHead`` (``asf_tpu/models/gru.py:119-217``):
per-pathway average pool with stride = window, concat, dropout (train
only), ``(B * N, F)`` -> ``(B, N, F)``, the GRU, ``projection_to_dim_in``
(2H -> sum(dim_in)), then ``projection_verb`` and ``projection_noun``, each
reduced by the mean over a chain's real windows: of the raw logits in
train mode, of the softmax (in float32) in eval mode.

With ``only_action_recognition`` off the head is the state head. The GRU
starts from the chain's CLIP noun embedding, (B, 512) tiled over the
layers and directions as h0 (so ``GRU_HIDDEN_SIZE`` must be its width; no
embedding: zeros), and three projections ``projection_min_1``,
``projection_0`` and ``projection_1`` (F -> P) give a third output: each
window's (3, P) logits, softmaxed over the 3 in eval mode only, then
reinterpreted in memory as (B, N, P, 3). That last step is the reference's
``.view`` of a contiguous (B * N, 3, P) tensor, which the JAX package
reproduces with a reshape (``gru.py:181-185``); it is not a transpose, and
the port keeps it. Padded windows are not masked there: the state loss
masks them through its labels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..parallel import tensor
from .heads import STATE_PROJECTIONS


def run_gru(gru: nn.GRU, x: torch.Tensor, host_lengths,
            h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gru`` (``batch_first``) over the first ``host_lengths[b]`` steps of
    each ``x[b]`` (B, N, F), from ``h0`` (layers * D, B, H) or zeros:
    (B, N, D * H), zeros after each length."""
    lengths = torch.as_tensor(host_lengths, dtype=torch.int64, device="cpu")
    order = torch.argsort(lengths, descending=True, stable=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(len(order))
    order_d, inverse_d = (t.to(x.device, non_blocking=True) for t in (order, inverse))
    packed = pack_padded_sequence(x.index_select(0, order_d), lengths[order], batch_first=True)
    if h0 is not None:
        h0 = h0.index_select(1, order_d)
    out, _ = gru(packed, h0)
    out = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])[0]
    return out.index_select(0, inverse_d)


def host_lengths_of(lengths: torch.Tensor, host_lengths):
    """The lengths to pack by: ``host_lengths``, or ``lengths`` itself when it
    lies on the host. A device tensor alone raises: reading it back would
    make the step wait for the card."""
    if host_lengths is not None:
        return host_lengths
    if lengths.device.type != "cpu":
        raise ValueError("packing needs the lengths on the host: pass host_lengths "
                         "(the prefetcher's batch carries them)")
    return lengths


class GRUResNetBasicHead(nn.Module):
    def __init__(self, dim_in: Sequence[int], num_classes, pool_size, dropout_rate=0.0,
                 act_func="softmax", gru_hidden_size=512, gru_num_layers=2,
                 only_action_recognition=True, dtype=torch.float32):
        super().__init__()
        self.with_state = not only_action_recognition
        want = 3 if self.with_state else 2
        if not isinstance(num_classes, (list, tuple)) or len(num_classes) != want:
            raise ValueError(
                f"the GRU head takes [verbs, nouns{', attributes' if self.with_state else ''}] "
                f"classes (MODEL.ONLY_ACTION_RECOGNITION {only_action_recognition}), not "
                f"{num_classes}")
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(f"{act_func} is not supported as an activation function.")
        self.pool_size = [tuple(p) for p in pool_size]
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0.0 else None
        self.gru = nn.GRU(sum(dim_in), gru_hidden_size, num_layers=gru_num_layers,
                          bidirectional=True, batch_first=True)
        self.projection_to_dim_in = nn.Linear(2 * gru_hidden_size, sum(dim_in))
        self.projection_verb = nn.Linear(sum(dim_in), num_classes[0])
        self.projection_noun = nn.Linear(sum(dim_in), num_classes[1])
        if self.with_state:
            for name in STATE_PROJECTIONS:
                self.add_module(name, nn.Linear(sum(dim_in), num_classes[2]))
        self.act_func = act_func
        self.compute_dtype = dtype

    def _linear(self, x, linear: nn.Linear):
        return tensor.linear(x, linear, self.compute_dtype)

    def _h0(self, noun_embedding: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The state head's h0: ``noun_embedding`` (B, H) tiled to
        (layers * 2, B, H) float32; None (zeros) for the action-only head or
        without an embedding."""
        if not self.with_state or noun_embedding is None:
            return None
        if noun_embedding.shape[-1] != self.gru.hidden_size:
            raise ValueError(
                f"the noun embedding is {noun_embedding.shape[-1]} wide: the state head's h0 "
                f"needs MODEL.GRU_HIDDEN_SIZE = {noun_embedding.shape[-1]}, not "
                f"{self.gru.hidden_size}")
        layers = 2 * self.gru.num_layers
        return noun_embedding.float()[None].expand(layers, -1, -1).contiguous()

    def forward(self, xs, lengths: torch.Tensor, chains, host_lengths=None,
                noun_embedding: Optional[torch.Tensor] = None):
        """``xs``: the trunk's pathways, (B * N, C, t, f) each; ``lengths``
        (B,) on their device; ``chains`` = (B, N); ``noun_embedding`` (B, H),
        read by the state head only. Returns (verb, noun), (B, classes)
        float32 each, and for the state head the state (B, N, P, 3) float32."""
        b, n = chains
        pooled = [F.avg_pool2d(x, w, stride=w) for x, w in zip(xs, self.pool_size)]
        x = torch.cat(pooled, dim=1).permute(0, 2, 3, 1)  # (B * N, 1, 1, C)
        if self.dropout is not None:
            x = self.dropout(x)
        x = x.reshape(b, n, x.shape[-1]).float()
        x = run_gru(self.gru, x, host_lengths_of(lengths, host_lengths), self._h0(noun_embedding))
        x = self._linear(x, self.projection_to_dim_in)
        mask = (torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]).float()
        denom = lengths.float().clamp(min=1.0)[:, None]

        def reduce(linear):
            y = self._linear(x, linear).float()  # (B, N, classes)
            if not self.training:
                y = torch.softmax(y, dim=-1) if self.act_func == "softmax" else torch.sigmoid(y)
            return (y * mask[:, :, None]).sum(dim=1) / denom

        out = reduce(self.projection_verb), reduce(self.projection_noun)
        if not self.with_state:
            return out
        s = torch.stack([self._linear(x, getattr(self, k)) for k in STATE_PROJECTIONS],
                        dim=2).float()  # (B, N, 3, P), contiguous: (B * N, 3, P) in memory
        if not self.training:
            s = torch.softmax(s, dim=2)
        return (*out, s.reshape(b, n, s.shape[-1], 3))  # the raw view, not a transpose
