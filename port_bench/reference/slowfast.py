"""The plain SlowFast-R50 audio model with its verb/noun heads and the biGRU head.

Kazakos et al., "Slow-Fast Auditory Streams for Audio Recognition" (ICASSP
2021), as the upstream ``auditory-slow-fast`` repository builds it: two
pathways of 2D convolutions over (time, frequency), a Slow pathway of T /
alpha frames and full width, a Fast pathway of every frame and 1 / beta of
the width, bottleneck ResNet-50 stages (3, 4, 6, 3 blocks) whose temporal
kernels (1 then 3 on Slow, 5 then 3 on Fast) sit on the first blocks of a
stage only, a lateral fusion after the stem and after stages 2 to 4 (a
(k, 1) convolution of stride (alpha, 1) on Fast, batch norm, ReLU,
concatenated onto Slow), then the head: each pathway average-pooled with a
window equal to its stride, concatenated, dropout and a linear projection per
task (verb, noun). The GRU model runs the same trunk over every window of a
chain, then a 2-layer bidirectional GRU over the windows, a projection back
to the trunk's width, and the verb and noun projections averaged over each
chain's real windows.

Parameters are passed as a dict keyed by dotted names (``s1.pathway0_stem.
conv.weight``, ``s2.pathway1_res0.branch2.a_bn.running_var``, ``head.
projection_verb.bias``, ``head.gru.weight_ih_l0_reverse``, ...), the names
of the upstream state dict, so that one dict of weights can be handed to this
model and to any program that keeps those names.

Everything computes in float32. Batch norm in training: every norm uses its
running statistics and leaves them (the fine-tune's frozen BN) except the two
stems' and the first fusion's, which normalise with the batch's statistics
(biased variance, eps 1e-5). In eval mode every norm uses its running
statistics. The GRU is written out from its gate equations, r, z, n:
``r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)``, ``z`` alike,
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``, ``h' = (1 - z) n + z h``;
the reverse direction reads each chain backwards from its last real window,
and outputs past a chain's length are zero (``pack_padded_sequence``).

``quant``, where given, rounds the inputs of every convolution and linear
product (the lower-precision control); ``count``, where given, is called with
each product's (kind, floating-point operations).

Departures from the published description: none in the equations. The
temporal kernel of the fusion and alpha are the caller's numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STAGE_DEPTH = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
TEMPORAL_KERNELS = [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]]
LIVE_BN = ("s1.pathway0_stem.bn", "s1.pathway1_stem.bn", "s1_fuse.bn")
OUTPUT_LEAVES = ("head.projection_verb.weight", "head.projection_noun.weight")  # the last layer


class Ctx:
    """What a forward needs besides the input: parameters, mode, hooks;
    ``dropout_mask(shape)`` gives the head's dropout mask in training."""

    def __init__(self, p: dict, train: bool, quant=None, count=None, dropout_mask=None,
                 calibrate: bool = False):
        self.p, self.train, self.quant, self.count = p, train, quant, count
        self.dropout_mask = dropout_mask
        self.calibrate = calibrate

    def q(self, t):
        return t if self.quant is None else self.quant(t)


def conv(ctx: Ctx, name: str, x, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    w = ctx.p[name + ".weight"]
    y = F.conv2d(ctx.q(x), ctx.q(w), None, stride, padding, dilation)
    if ctx.count is not None:
        ctx.count("conv", 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
    return y


def bn(ctx: Ctx, name: str, x):
    p = ctx.p
    if ctx.calibrate:  # running statistics set to this batch's (momentum 1)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        p[name + ".running_mean"].copy_(mean)
        p[name + ".running_var"].copy_(var)
    live = ctx.train and name in LIVE_BN
    return F.batch_norm(x, None if live else p[name + ".running_mean"],
                        None if live else p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], live, 0.0, 1e-5)


def linear(ctx: Ctx, name: str, x):
    w, b = ctx.p[name + ".weight"], ctx.p[name + ".bias"]
    if ctx.count is not None:
        ctx.count("linear", 2 * x.numel() // x.shape[-1] * w.shape[0] * w.shape[1])
    return F.linear(ctx.q(x), ctx.q(w), b)


def stem(ctx, name, x, tk):
    x = conv(ctx, name + ".conv", x, (2, 2), (tk // 2, 3))
    return F.max_pool2d(F.relu(bn(ctx, name + ".bn", x)), 3, 2, 1)


def fuse(ctx, name, xs, alpha, k):
    slow, fast = xs
    f = F.relu(bn(ctx, name + ".bn", conv(ctx, name + ".conv_f2s", fast, (alpha, 1),
                                          (k // 2, 0))))
    return [torch.cat([slow, f], 1), fast]


def block(ctx, name, x, tk, stride, dilation, project):
    b = name + ".branch2"
    y = F.relu(bn(ctx, b + ".a_bn", conv(ctx, b + ".a", x, (1, 1), (tk // 2, 0))))
    y = F.relu(bn(ctx, b + ".b_bn", conv(ctx, b + ".b", y, (1, stride), (0, dilation),
                                         (1, dilation))))
    y = bn(ctx, b + ".c_bn", conv(ctx, b + ".c", y))
    short = bn(ctx, name + ".branch1_bn", conv(ctx, name + ".branch1", x, (1, stride))) \
        if project else x
    return F.relu(short + y)


def param_shapes(m: dict) -> dict:
    """Every parameter and buffer of the model of numbers ``m``, name -> shape,
    in the upstream state dict's order of modules."""
    out = {}

    def conv_(name, o, i, kt, kf):
        out[name + ".weight"] = (o, i, kt, kf)

    def bn_(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{leaf}"] = (c,)
        out[name + ".num_batches_tracked"] = ()

    w, beta, ratio, k = m["width"], m["beta_inv"], m["fusion_ratio"], m["fusion_kernel"]
    for p, c in enumerate((w, w // beta)):
        conv_(f"s1.pathway{p}_stem.conv", c, 1, TEMPORAL_KERNELS[0][p][0], 7)
        bn_(f"s1.pathway{p}_stem.bn", c)
    conv_("s1_fuse.conv_f2s", w // beta * ratio, w // beta, k, 1)
    bn_("s1_fuse.bn", w // beta * ratio)
    dims = [(w, w * 4, w), (w * 4, w * 8, w * 2), (w * 8, w * 16, w * 4), (w * 16, w * 32, w * 8)]
    for s, (di, do, dn) in enumerate(dims):
        ins = [di + di // (beta // ratio), di // beta]
        outs, inners = [do, do // beta], [dn, dn // beta]
        for p in range(2):
            n_temp = m["num_block_temp_kernel"][s][p]
            for i in range(STAGE_DEPTH[m["depth"]][s]):
                name = f"s{s + 2}.pathway{p}_res{i}"
                cin = ins[p] if i == 0 else outs[p]
                if cin != outs[p] or (i == 0 and m["frequency_strides"][s][p] != 1):
                    conv_(name + ".branch1", outs[p], cin, 1, 1)
                    bn_(name + ".branch1_bn", outs[p])
                tk = TEMPORAL_KERNELS[s + 1][p][0] if i < n_temp else 1
                b = name + ".branch2"
                conv_(b + ".a", inners[p], cin, tk, 1)
                bn_(b + ".a_bn", inners[p])
                conv_(b + ".b", inners[p], inners[p], 1, 3)
                bn_(b + ".b_bn", inners[p])
                conv_(b + ".c", outs[p], inners[p], 1, 1)
                bn_(b + ".c_bn", outs[p])
        if s < 3:
            conv_(f"s{s + 2}_fuse.conv_f2s", do // beta * ratio, do // beta, k, 1)
            bn_(f"s{s + 2}_fuse.bn", do // beta * ratio)
    feat = w * 32 + w * 32 // beta
    if m.get("gru_layers"):
        hidden = m["gru_hidden"]
        for layer in range(m["gru_layers"]):
            for sfx in ("", "_reverse"):
                i = feat if layer == 0 else 2 * hidden
                out[f"head.gru.weight_ih_l{layer}{sfx}"] = (3 * hidden, i)
                out[f"head.gru.weight_hh_l{layer}{sfx}"] = (3 * hidden, hidden)
                out[f"head.gru.bias_ih_l{layer}{sfx}"] = (3 * hidden,)
                out[f"head.gru.bias_hh_l{layer}{sfx}"] = (3 * hidden,)
        out["head.projection_to_dim_in.weight"] = (feat, 2 * hidden)
        out["head.projection_to_dim_in.bias"] = (feat,)
    for task, n in zip(("verb", "noun"), m["num_classes"]):
        out[f"head.projection_{task}.weight"] = (n, feat)
        out[f"head.projection_{task}.bias"] = (n,)
    return out


def trunk(ctx: Ctx, xs: list, m: dict) -> list:
    """[slow (R, 1, T / alpha, F), fast (R, 1, T, F)] -> the stage-5 pathways."""
    alpha, k = m["alpha"], m["fusion_kernel"]
    xs = [stem(ctx, f"s1.pathway{p}_stem", x, TEMPORAL_KERNELS[0][p][0])
          for p, x in enumerate(xs)]
    xs = fuse(ctx, "s1_fuse", xs, alpha, k)
    depths = STAGE_DEPTH[m["depth"]]
    for s in range(4):
        out = []
        for p, x in enumerate(xs):
            n_temp = m["num_block_temp_kernel"][s][p]
            for i in range(depths[s]):
                tk = TEMPORAL_KERNELS[s + 1][p][0] if i < n_temp else 1
                name = f"s{s + 2}.pathway{p}_res{i}"
                x = block(ctx, name, x, tk, m["frequency_strides"][s][p] if i == 0 else 1,
                          m["frequency_dilations"][s][p],
                          name + ".branch1.weight" in ctx.p)
            out.append(x)
        xs = out
        if s < 3:
            xs = fuse(ctx, f"s{s + 2}_fuse", xs, alpha, k)
    return xs


def pooled(ctx: Ctx, xs: list, m: dict) -> torch.Tensor:
    """The head's per-pathway average pool, concatenated: (R, t', f', C)."""
    t, f, alpha = m["num_frames"], m["n_mels"], m["alpha"]
    windows = [(t // alpha // 4, f // 32), (t // 4, f // 32)]
    x = torch.cat([F.avg_pool2d(x, w, stride=w) for x, w in zip(xs, windows)], 1)
    x = x.permute(0, 2, 3, 1)
    if ctx.train and ctx.dropout_mask is not None:
        x = x * ctx.dropout_mask(tuple(x.shape))
    return x


def clip_head(ctx: Ctx, x: torch.Tensor) -> tuple:
    """Verb and noun: raw logits (B, classes) in training, else softmax then
    the mean over the (t', f') positions."""
    out = []
    for task in ("verb", "noun"):
        y = linear(ctx, f"head.projection_{task}", x)
        if not ctx.train:
            y = torch.softmax(y, -1).mean(dim=(1, 2))
        out.append(y.reshape(y.shape[0], -1))
    return tuple(out)


def gru_direction(ctx: Ctx, x: torch.Tensor, lengths: list, layer: int, reverse: bool):
    """One direction of one layer: x (B, N, I) -> (B, N, H), zeros past each length."""
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    p = ctx.p
    w_ih, w_hh = p["head.gru.weight_ih" + sfx], p["head.gru.weight_hh" + sfx]
    b_ih, b_hh = p["head.gru.bias_ih" + sfx], p["head.gru.bias_hh" + sfx]
    b, n, _ = x.shape
    hidden = w_hh.shape[1]
    if ctx.count is not None:  # the gate products of every real window
        ctx.count("gru", 2 * sum(lengths) * 3 * hidden * (w_ih.shape[1] + hidden))
    lens = torch.tensor(lengths, device=x.device)
    steps = torch.arange(n, device=x.device)
    alive = steps[None, :] < lens[:, None]  # (B, N)
    if reverse:  # each chain read backwards within its length; the padding stays
        idx = torch.where(alive, lens[:, None] - 1 - steps[None, :], steps[None, :])
        x = x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    gi = F.linear(ctx.q(x), ctx.q(w_ih), b_ih)  # (B, N, 3H)
    h = x.new_zeros(b, hidden)
    outs = []
    for step in range(n):
        g = gi[:, step]
        gh = F.linear(ctx.q(h), ctx.q(w_hh), b_hh)
        r = torch.sigmoid(g[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(g[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        cand = torch.tanh(g[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        live = alive[:, step, None]
        h = torch.where(live, (1 - z) * cand + z * h, h)
        outs.append(torch.where(live, h, torch.zeros_like(h)))
    out = torch.stack(outs, 1)
    if reverse:
        out = out.gather(1, idx[:, :, None].expand(-1, -1, hidden))
    return out


def gru_head(ctx: Ctx, x: torch.Tensor, chains: tuple, lengths: list, m: dict) -> tuple:
    """x (B * N, 1, 1, C) -> verb and noun (B, classes): the biGRU over each
    chain's windows, the projection back to C, the task projections, and the
    mean over the real windows (of raw logits in training, else of softmax)."""
    b, n = chains
    x = x.reshape(b, n, x.shape[-1])
    for layer in range(m["gru_layers"]):
        x = torch.cat([gru_direction(ctx, x, lengths, layer, False),
                       gru_direction(ctx, x, lengths, layer, True)], -1)
    x = linear(ctx, "head.projection_to_dim_in", x)
    lens = torch.tensor(lengths, device=x.device, dtype=torch.float32)
    mask = (torch.arange(n, device=x.device)[None, :] < lens[:, None]).float()
    out = []
    for task in ("verb", "noun"):
        y = linear(ctx, f"head.projection_{task}", x)
        if not ctx.train:
            y = torch.softmax(y, -1)
        out.append((y * mask[:, :, None]).sum(1) / lens.clamp(min=1.0)[:, None])
    return tuple(out)


def forward(ctx: Ctx, paths: list, m: dict, chains=None, lengths=None) -> tuple:
    """Single clips: paths (B, 1, T', F) each. Chains: paths (B * N, 1, T', F)
    with ``chains`` = (B, N) and each chain's length."""
    x = pooled(ctx, trunk(ctx, paths, m), m)
    if chains is None:
        return clip_head(ctx, x)
    return gru_head(ctx, x, chains, lengths, m)
