"""Sparse image warp (polyharmonic spline + bilinear dense warp), batched.

Counterpart of ``asf_tpu/dsp/warp.py:44-145`` for SpecAugment's case, one
control point and the order-2 (thin-plate) spline: ``interpolate_spline``
(the JAX package's closed form for one point), ``interpolate_bilinear`` and
``sparse_image_warp``, each over a leading batch axis. The gather-free
``warp_time_taps``/``sparse_image_warp_time`` of the JAX package
(``:146-191``) works around gathers on the TPU's vector unit and is not
ported: ``interpolate_bilinear`` gathers, which is what the card is good at.
The JAX package states the two give the same output to float32 noise while
the flow stays within its tap window.
"""

from __future__ import annotations

import torch


def _phi(r2: torch.Tensor) -> torch.Tensor:
    """The order-2 polyharmonic radial basis on squared distances: 1/2 r^2 log r^2."""
    return 0.5 * r2 * torch.log(r2.clamp(min=1e-10))


def _cross_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, n, d), (B, m, d) -> (B, n, m) pairwise squared distances."""
    xn = torch.square(x).sum(dim=-1, keepdim=True)
    yn = torch.square(y).sum(dim=-1, keepdim=True)
    return xn - 2.0 * (x @ y.transpose(1, 2)) + yn.transpose(1, 2)


def interpolate_spline(train_points: torch.Tensor, train_values: torch.Tensor,
                       query_points: torch.Tensor, regularization: float = 1e-6) -> torch.Tensor:
    """Fits the ridged thin-plate spline through one control point and
    evaluates it at the queries.

    train_points (B, 1, d), train_values (B, 1, k), query_points (B, m, d) ->
    (B, m, k). The system [[a+r, b], [b^T, r I]] [w; v] = [val; 0] solves by
    block elimination: v = -(w/r) b^T, w = val / (a + r - |b|^2/r).
    """
    bsz, n, _ = train_points.shape
    if n != 1:
        raise ValueError(f"one control point is ported (SpecAugment's case), got {n}")
    r = regularization
    a = _phi(_cross_sq_dists(train_points, train_points))  # (B, 1, 1)
    b1 = torch.cat([train_points[:, 0], train_points.new_ones(bsz, 1)], dim=1)  # (B, d+1)
    denom = a[:, 0, 0] + r - torch.square(b1).sum(dim=1) / r  # (B,)
    w = train_values / denom[:, None, None]  # (B, 1, k)
    v = (-w / r) * b1[:, :, None]  # (B, d+1, k)
    q_phi = _phi(_cross_sq_dists(query_points, train_points))  # (B, m, 1)
    q_aug = torch.cat([query_points, torch.ones_like(query_points[..., :1])], dim=2)
    return q_phi @ w + q_aug @ v


def interpolate_bilinear(grid: torch.Tensor, query_points: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images, (B, m, 2) float (y, x) queries -> (B, m) bilinear samples.

    The edges of the reference port (``sparse_image_warp.py:264-354``): the
    floors clamped to [0, size - 2], the fractions to [0, 1].
    """
    bsz, h, w = grid.shape
    qy, qx = query_points[..., 0], query_points[..., 1]
    fy = torch.floor(qy).clamp(0.0, h - 2.0)
    fx = torch.floor(qx).clamp(0.0, w - 2.0)
    ay = (qy - fy).clamp(0.0, 1.0)
    ax = (qx - fx).clamp(0.0, 1.0)
    flat = grid.reshape(bsz, h * w)
    idx = fy.long() * w + fx.long()

    def at(offset):
        return flat.gather(1, idx + offset)

    tl, tr, bl, br = at(0), at(1), at(w), at(w + 1)
    top = tl + ax * (tr - tl)
    bot = bl + ax * (br - bl)
    return top + ay * (bot - top)


def sparse_image_warp(image: torch.Tensor, src_points: torch.Tensor, dst_points: torch.Tensor,
                      regularization: float = 1e-6) -> torch.Tensor:
    """Warps (B, H, W) images so that pixels move like the src -> dst flow.

    ``out[y, x] = image[(y, x) - flow(y, x)]``, the flow interpolated by the
    thin-plate spline from the control point's flow at the dst location (TF
    semantics). src/dst points are (B, 1, 2) (y, x).
    """
    bsz, h, w = image.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=image.dtype, device=image.device),
                            torch.arange(w, dtype=image.dtype, device=image.device),
                            indexing="ij")
    queries = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=1).expand(bsz, h * w, 2)
    dst = dst_points.to(image.dtype)
    flow = interpolate_spline(dst, dst - src_points.to(image.dtype), queries, regularization)
    return interpolate_bilinear(image, queries - flow).reshape(bsz, h, w)
