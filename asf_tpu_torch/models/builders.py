"""Model builders and registry.

Counterparts of ``asf_tpu/models/builders.py:29-395``: the
two-pathway SlowFast trunk with its lateral fusions, ``AudioSlowFast``,
``AudioSlowFastGRU`` (the same trunk over every window of a chain, then
the GRU head), the single-pathway Slow-only or Fast-only ``ResNet``
(``MODEL.ARCH`` "slow" or "fast"), ``MODEL_REGISTRY`` and ``build_model``
(with the upstream "SlowFast" alias). Submodule names follow the JAX tree
(``s1``, ``s1_fuse``, ..., ``s5``, ``head``). With
``MODEL.ONLY_ACTION_RECOGNITION`` off the two SlowFast models carry the
state head: ``build_model`` appends the number of PDDL attributes (the rows
of the ``MODEL.PDDL_ATTRIBUTES`` csv) to a two-class ``NUM_CLASSES``, and a
verb/noun config that gets no third class raises. ``ResNet`` has no state
head; a verb/noun ``ResNet`` config builds its two projections whatever
``ONLY_ACTION_RECOGNITION`` says, as in the JAX package.

Initialisation follows the JAX package from an explicit ``torch.Generator``:
convs draw Caffe2 MSRA fill (normal, std sqrt(2 / fan_out), fan_out =
out_channels * kernel area; ``asf_tpu/models/layers.py:28``), the
projection normal(0, ``MODEL.FC_INIT_STD``) with a zero bias
(``heads.py:26``), every GRU weight and bias U(-1/sqrt(H), 1/sqrt(H))
(``gru.py:32-40``), BN weight one (zero on the final BN of a block under
``RESNET.ZERO_INIT_FINAL_BN``) and bias zero.
"""

from __future__ import annotations

import csv
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.torch_setup import resolve_device
from .gru import GRUResNetBasicHead
from .heads import ResNetBasicHead
from .layers import AudioModelStem, Conv2d, FuseFastToSlow, ResStage
from .norm import make_norm

# 50/101 match the upstream builder; 26 is a tiny variant (1 block/stage)
# for tests.
_MODEL_STAGE_DEPTH = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# Temporal kernel basis per arch, stage and pathway.
_TEMPORAL_KERNEL_BASIS = {
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "fast": [[[5]], [[3]], [[3]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
}

# pool1 windows per arch and pathway (identity at the audio geometry).
_POOL1 = {"slow": [[1, 1]], "fast": [[1, 1]], "slowfast": [[1, 1], [1, 1]]}

MODEL_REGISTRY = {}


def register_model(name):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def compute_dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.GPU.COMPUTE_DTYPE]


def head_pool_sizes(cfg, pool_size, pathways):
    """Head average-pool windows of the ``pathways`` (1 or 2), from the input geometry."""
    T, F_ = cfg.AUDIO_DATA.NUM_FRAMES, cfg.AUDIO_DATA.NUM_FREQUENCIES
    alpha = cfg.SLOWFAST.ALPHA
    if pathways == 2:
        return [
            [T // alpha // 4 // pool_size[0][0], F_ // 32 // pool_size[0][1]],
            [T // 4 // pool_size[1][0], F_ // 32 // pool_size[1][1]],
        ]
    return [[T // 4 // pool_size[0][0], F_ // 32 // pool_size[0][1]]]


def _num_classes(cfg):
    nc = cfg.MODEL.NUM_CLASSES
    return list(nc) if len(nc) > 1 else nc[0]


class _SlowFastTrunk(nn.Module):
    """The two-pathway trunk: [slow, fast] (B, 1, T', F) -> the s5 pathways."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        w = cfg.RESNET.WIDTH_PER_GROUP
        ng = cfg.RESNET.NUM_GROUPS
        dim_inner = ng * w
        beta = cfg.SLOWFAST.BETA_INV
        ratio = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO
        fuse_k = cfg.SLOWFAST.FUSION_KERNEL_SZ
        alpha = cfg.SLOWFAST.ALPHA
        out_dim_ratio = beta // ratio
        tk = _TEMPORAL_KERNEL_BASIS["slowfast"]
        norm = make_norm(cfg)
        common = dict(
            trans_func_name=cfg.RESNET.TRANS_FUNC,
            stride_1x1=cfg.RESNET.STRIDE_1X1,
            norm=norm,
            dtype=dtype,
            zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
        )

        self.s1 = AudioModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM,
            dim_out=[w, w // beta],
            kernel=[tk[0][0] + [7], tk[0][1] + [7]],
            stride=[[2, 2]] * 2,
            padding=[[tk[0][0][0] // 2, 3], [tk[0][1][0] // 2, 3]],
            norm=norm,
            dtype=dtype,
        )
        self.s1_fuse = FuseFastToSlow(w // beta, ratio, fuse_k, alpha, norm, dtype,
                                      bn_freeze_exempt=True)
        widths = [
            (w, w * 4, dim_inner, d2),
            (w * 4, w * 8, dim_inner * 2, d3),
            (w * 8, w * 16, dim_inner * 4, d4),
            (w * 16, w * 32, dim_inner * 8, d5),
        ]
        for si, (di, do, dn, nb) in enumerate(widths):
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[di + di // out_dim_ratio, di // beta],
                dim_out=[do, do // beta],
                dim_inner=[dn, dn // beta],
                temp_kernel_sizes=tk[si + 1],
                stride=cfg.RESNET.FREQUENCY_STRIDES[si],
                num_blocks=[nb] * 2,
                num_groups=[ng] * 2,
                num_block_temp_kernel=cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si],
                dilation=cfg.RESNET.FREQUENCY_DILATIONS[si],
                **common,
            ))
            if si < 3:
                self.add_module(
                    f"s{si + 2}_fuse", FuseFastToSlow(do // beta, ratio, fuse_k, alpha, norm, dtype)
                )
        self.pool1 = [tuple(p) for p in _POOL1["slowfast"]]

    def trunk(self, xs):
        xs = self.s1_fuse(self.s1(xs))
        xs = self.s2_fuse(self.s2(xs))
        xs = [F.max_pool2d(x, p, stride=p) for x, p in zip(xs, self.pool1)]
        xs = self.s3_fuse(self.s3(xs))
        xs = self.s4_fuse(self.s4(xs))
        return self.s5(xs)


def _head_dims(cfg) -> list:
    w, beta = cfg.RESNET.WIDTH_PER_GROUP, cfg.SLOWFAST.BETA_INV
    return [w * 32, w * 32 // beta]


@register_model("AudioSlowFast")
class AudioSlowFast(_SlowFastTrunk):
    """Two-stream SlowFast audio classifier: [slow, fast] (B, 1, T', F) -> head."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        self.head = ResNetBasicHead(
            dim_in=_head_dims(cfg),
            num_classes=_num_classes(cfg),
            pool_size=head_pool_sizes(cfg, _POOL1["slowfast"], 2),
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT,
            dtype=dtype,
            with_state=_with_state(cfg),
        )

    def forward(self, xs):
        return self.head(self.trunk(xs))


@register_model("AudioSlowFastGRU")
class AudioSlowFastGRU(_SlowFastTrunk):
    """The SlowFast trunk over every window of a chain, then the GRU head:
    [slow, fast] (B, N, 1, T', F) and ``lengths`` (B,) -> (verb, noun), and
    for the state head the state (B, N, P, 3) from the ``noun_embedding`` h0."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__(cfg, dtype)
        self.head = GRUResNetBasicHead(
            dim_in=_head_dims(cfg),
            num_classes=_num_classes(cfg),
            pool_size=head_pool_sizes(cfg, _POOL1["slowfast"], 2),
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT,
            gru_hidden_size=cfg.MODEL.GRU_HIDDEN_SIZE,
            gru_num_layers=cfg.MODEL.GRU_NUM_LAYERS,
            only_action_recognition=cfg.MODEL.ONLY_ACTION_RECOGNITION,
            dtype=dtype,
        )

    def forward(self, xs, lengths, noun_embedding=None, host_lengths=None):
        """``noun_embedding`` (B, 512) is the state head's h0 (the action-only
        head does not read it); ``host_lengths`` as in ``gru.run_gru``."""
        chains = tuple(xs[0].shape[:2])
        feats = self.trunk([x.reshape(-1, *x.shape[2:]) for x in xs])
        return self.head(feats, lengths, chains, host_lengths, noun_embedding)


@register_model("ResNet")
class ResNet(nn.Module):
    """Single-pathway Slow-only or Fast-only ResNet (``MODEL.ARCH`` "slow"
    or "fast"): [x] (B, 1, T', F) -> head. The stem ``s1.pathway0_stem``,
    stages ``s2``..``s5`` of one pathway each (the first entry of each
    pathway list of ``RESNET``), no lateral fusion, and a one-pathway head
    of ``WIDTH_PER_GROUP * 32`` inputs."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        arch = cfg.MODEL.ARCH
        if arch not in ("slow", "fast"):
            raise ValueError(f"ResNet takes MODEL.ARCH 'slow' or 'fast', not {arch!r}")
        tk = _TEMPORAL_KERNEL_BASIS[arch]
        d2, d3, d4, d5 = _MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH]
        w = cfg.RESNET.WIDTH_PER_GROUP
        ng = cfg.RESNET.NUM_GROUPS
        dim_inner = ng * w
        norm = make_norm(cfg)
        self.s1 = AudioModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM,  # the first pathway's
            dim_out=[w],
            kernel=[tk[0][0] + [7]],
            stride=[[2, 2]],
            padding=[[tk[0][0][0] // 2, 3]],
            norm=norm,
            dtype=dtype,
        )
        widths = [(w, w * 4, dim_inner, d2), (w * 4, w * 8, dim_inner * 2, d3),
                  (w * 8, w * 16, dim_inner * 4, d4), (w * 16, w * 32, dim_inner * 8, d5)]
        for si, (di, do, dn, nb) in enumerate(widths):
            self.add_module(f"s{si + 2}", ResStage(
                dim_in=[di],
                dim_out=[do],
                dim_inner=[dn],
                temp_kernel_sizes=tk[si + 1],
                stride=cfg.RESNET.FREQUENCY_STRIDES[si],
                num_blocks=[nb],
                num_groups=[ng],
                num_block_temp_kernel=cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[si],
                dilation=cfg.RESNET.FREQUENCY_DILATIONS[si],
                trans_func_name=cfg.RESNET.TRANS_FUNC,
                stride_1x1=cfg.RESNET.STRIDE_1X1,
                norm=norm,
                dtype=dtype,
                zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
            ))
        self.pool1 = tuple(_POOL1[arch][0])
        self.head = ResNetBasicHead(
            dim_in=[w * 32],
            num_classes=_num_classes(cfg),
            pool_size=head_pool_sizes(cfg, _POOL1[arch], 1),
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT,
            dtype=dtype,
        )

    def forward(self, xs):
        xs = self.s2(self.s1(xs))
        xs = [F.max_pool2d(x, self.pool1, stride=self.pool1) for x in xs]
        return self.head(self.s5(self.s4(self.s3(xs))))


@torch.no_grad()
def init_weights(model: nn.Module, fc_init_std: float, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn in module order from ``generator``."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            fan_out = m.out_channels * math.prod(m.kernel_size)
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, fc_init_std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)


def build_model(cfg, device=None, generator: torch.Generator | None = None) -> nn.Module:
    """Instantiate the registered model for ``cfg.MODEL.MODEL_NAME`` on ``device``.

    The weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given), so a seed gives the same model on every device.
    """
    device = resolve_device(device)
    name = cfg.MODEL.MODEL_NAME
    # Upstream YAMLs name this architecture "SlowFast".
    name = {"SlowFast": "AudioSlowFast"}.get(name, name)
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Model {name} not registered; have {sorted(MODEL_REGISTRY)}")
    if name in ("AudioSlowFast", "AudioSlowFastGRU") and not cfg.MODEL.ONLY_ACTION_RECOGNITION:
        _maybe_append_state_classes(cfg)
        if len(cfg.MODEL.NUM_CLASSES) == 2:
            raise ValueError(
                f"NUM_CLASSES {list(cfg.MODEL.NUM_CLASSES)} with MODEL.ONLY_ACTION_RECOGNITION "
                "off: the state head needs the PDDL attributes, MODEL.PDDL_ATTRIBUTES = "
                f"{cfg.MODEL.PDDL_ATTRIBUTES!r} names no .csv of them (or set "
                "ONLY_ACTION_RECOGNITION on for verb/noun alone)")
    model = MODEL_REGISTRY[name](cfg, dtype=compute_dtype(cfg))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, cfg.MODEL.FC_INIT_STD, generator)
    return model.to(device)


def _with_state(cfg) -> bool:
    """The single-clip head's state projections: a third class and
    ``ONLY_ACTION_RECOGNITION`` off (``asf_tpu/models/builders.py:232-236``)."""
    nc = cfg.MODEL.NUM_CLASSES
    return not cfg.MODEL.ONLY_ACTION_RECOGNITION and len(nc) > 2


def _maybe_append_state_classes(cfg):
    """Append len(PDDL attributes) to NUM_CLASSES (the upstream state head)."""
    if isinstance(cfg.MODEL.PDDL_ATTRIBUTES, str) and cfg.MODEL.PDDL_ATTRIBUTES.endswith(".csv"):
        with open(cfg.MODEL.PDDL_ATTRIBUTES, newline="") as f:  # no pandas on the card
            attrs = [row["attribute"] for row in csv.DictReader(f)]
        if len(cfg.MODEL.NUM_CLASSES) == 2:
            cfg.MODEL.NUM_CLASSES.append(len(attrs))
