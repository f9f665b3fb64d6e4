"""Conv trunk building blocks (NCHW = (B, C, T, F)).

Counterparts of ``asf_tpu/models/layers.py:137-422``. Module names follow
the JAX tree, which is the upstream torch state dict
(``s1.pathway0_stem.conv``, ``s2.pathway1_res0.branch2.a_bn``, ...), so a
converted JAX checkpoint loads with ``load_state_dict(strict=True)``.

dtype policy of the JAX package: parameters are float32 and each conv casts
its input and weight to the compute dtype at use
(``nn.Conv(dtype=..., param_dtype=float32)``). ``Stride2StemConv``
(``layers.py:64-134``) works around the TPU's matrix unit and is not
ported: the stems use the plain strided conv. A conv that
``parallel/tensor.py:shard_model`` sharded (``shard`` set) computes its
block of the output channels and gathers the blocks of its model group.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor


class Conv2d(nn.Conv2d):
    """Bias-free Conv2d that computes in ``dtype`` from float32 parameters."""

    def __init__(self, dim_in, dim_out, kernel, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, dtype=torch.float32):
        super().__init__(dim_in, dim_out, tuple(kernel), tuple(stride), tuple(padding),
                         tuple(dilation), groups, bias=False)
        self.compute_dtype = dtype
        self.shard = None

    def forward(self, x):
        dt = self.compute_dtype
        if self.shard is not None:
            return tensor.conv2d(self, x, dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class ResNetBasicStem(nn.Module):
    """Conv([t,7], stride [2,2]) + BN + ReLU + MaxPool(3x3, stride 2, pad 1).

    The stem BN is exempt from ``BN.FREEZE`` (``asf_tpu/models/layers.py:165-168``).
    """

    def __init__(self, dim_in, dim_out, kernel, stride, padding, norm: Callable,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, kernel, stride, padding, dtype=dtype)
        self.bn = norm(dim_out, freeze_exempt=True)
        self.pool = nn.MaxPool2d(3, 2, 1)

    def forward(self, x):
        return self.pool(F.relu(self.bn(self.conv(x))))


class AudioModelStem(nn.Module):
    """Per-pathway stems, named ``pathway{i}_stem``."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int], kernel, stride, padding,
                 norm: Callable, dtype=torch.float32):
        super().__init__()
        self.num_pathways = len(dim_out)
        for p in range(self.num_pathways):
            self.add_module(f"pathway{p}_stem", ResNetBasicStem(
                dim_in[p], dim_out[p], kernel[p], stride[p], padding[p], norm, dtype,
            ))

    def forward(self, xs):
        assert len(xs) == self.num_pathways
        return [getattr(self, f"pathway{p}_stem")(x) for p, x in enumerate(xs)]


class FuseFastToSlow(nn.Module):
    """Conv([k,1], stride [alpha,1]) on Fast + BN + ReLU, concatenated onto Slow.

    ``bn_freeze_exempt`` keeps the BN's statistics live under ``BN.FREEZE``
    (s1's fuse only, ``asf_tpu/models/builders.py:131``).
    """

    def __init__(self, dim_in, fusion_conv_channel_ratio, fusion_kernel, alpha,
                 norm: Callable, dtype=torch.float32, bn_freeze_exempt=False):
        super().__init__()
        dim_out = dim_in * fusion_conv_channel_ratio
        self.conv_f2s = Conv2d(dim_in, dim_out, (fusion_kernel, 1), (alpha, 1),
                               (fusion_kernel // 2, 0), dtype=dtype)
        self.bn = norm(dim_out, freeze_exempt=bn_freeze_exempt)

    def forward(self, xs):
        x_s, x_f = xs
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=1), x_f]


class BasicTransform(nn.Module):
    """Tx3 + BN + ReLU + 1x3 + BN."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, norm: Callable,
                 dtype=torch.float32, zero_init_final_bn=False):
        super().__init__()
        self.a = Conv2d(dim_in, dim_out, (temp_kernel_size, 3), (1, stride),
                        (temp_kernel_size // 2, 1), dtype=dtype)
        self.a_bn = norm(dim_out)
        self.b = Conv2d(dim_out, dim_out, (1, 3), (1, 1), (0, 1), dtype=dtype)
        self.b_bn = norm(dim_out)
        if zero_init_final_bn:
            nn.init.zeros_(self.b_bn.weight)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        return self.b_bn(self.b(x))


class BottleneckTransform(nn.Module):
    """Tx1 + 1x3 (grouped, dilated) + 1x1, BN and ReLU between."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups=1,
                 stride_1x1=False, dilation=1, norm: Callable = None, dtype=torch.float32,
                 zero_init_final_bn=False):
        super().__init__()
        str1x1, str3x3 = (stride, 1) if stride_1x1 else (1, stride)
        self.a = Conv2d(dim_in, dim_inner, (temp_kernel_size, 1), (1, str1x1),
                        (temp_kernel_size // 2, 0), dtype=dtype)
        self.a_bn = norm(dim_inner)
        self.b = Conv2d(dim_inner, dim_inner, (1, 3), (1, str3x3), (0, dilation),
                        (1, dilation), groups=num_groups, dtype=dtype)
        self.b_bn = norm(dim_inner)
        self.c = Conv2d(dim_inner, dim_out, (1, 1), dtype=dtype)
        self.c_bn = norm(dim_out)
        if zero_init_final_bn:
            nn.init.zeros_(self.c_bn.weight)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class ResBlock(nn.Module):
    """Residual block with a projection shortcut on a width or stride change."""

    def __init__(self, dim_in, dim_out, temp_kernel_size, stride, trans_func_name, dim_inner,
                 num_groups=1, stride_1x1=False, dilation=1, norm: Callable = None,
                 dtype=torch.float32, zero_init_final_bn=False):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv2d(dim_in, dim_out, (1, 1), (1, stride), dtype=dtype)
            self.branch1_bn = norm(dim_out)
        else:
            self.branch1 = None
        if trans_func_name == "bottleneck_transform":
            self.branch2 = BottleneckTransform(
                dim_in, dim_out, temp_kernel_size, stride, dim_inner, num_groups, stride_1x1,
                dilation, norm, dtype, zero_init_final_bn,
            )
        elif trans_func_name == "basic_transform":
            self.branch2 = BasicTransform(
                dim_in, dim_out, temp_kernel_size, stride, norm, dtype, zero_init_final_bn
            )
        else:
            raise NotImplementedError(f"RESNET.TRANS_FUNC {trans_func_name!r}")

    def forward(self, x):
        shortcut = x if self.branch1 is None else self.branch1_bn(self.branch1(x))
        return F.relu(shortcut + self.branch2(x))


class ResStage(nn.Module):
    """Per-pathway chains of ResBlocks, named ``pathway{p}_res{i}``; temporal
    kernels only on the first ``num_block_temp_kernel`` blocks."""

    def __init__(self, dim_in, dim_out, stride, temp_kernel_sizes, num_blocks, dim_inner,
                 num_groups, num_block_temp_kernel, dilation,
                 trans_func_name="bottleneck_transform", stride_1x1=False,
                 norm: Callable = None, dtype=torch.float32, zero_init_final_bn=False):
        super().__init__()
        self.num_blocks = list(num_blocks)
        for p in range(len(num_blocks)):
            tks = (list(temp_kernel_sizes[p]) * num_blocks[p])[: num_block_temp_kernel[p]] + [1] * (
                num_blocks[p] - num_block_temp_kernel[p]
            )
            for i in range(num_blocks[p]):
                self.add_module(f"pathway{p}_res{i}", ResBlock(
                    dim_in=dim_in[p] if i == 0 else dim_out[p],
                    dim_out=dim_out[p],
                    temp_kernel_size=tks[i],
                    stride=stride[p] if i == 0 else 1,
                    trans_func_name=trans_func_name,
                    dim_inner=dim_inner[p],
                    num_groups=num_groups[p],
                    stride_1x1=stride_1x1,
                    dilation=dilation[p],
                    norm=norm,
                    dtype=dtype,
                    zero_init_final_bn=zero_init_final_bn,
                ))

    def forward(self, xs):
        assert len(xs) == len(self.num_blocks)
        out = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks[p]):
                x = getattr(self, f"pathway{p}_res{i}")(x)
            out.append(x)
        return out
