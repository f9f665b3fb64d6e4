"""SpecAugment and the sparse warp of the port against the JAX package.

``torch`` cannot replay ``jax.random``, so the apply is held against
``asf_tpu.dsp.specaugment.spec_augment_single`` on the integers JAX draws:
the test re-derives them by the same key splits
(``asf_tpu/dsp/specaugment.py:37-41, 56-63, 84``) and hands them to the
port's ``apply``. The port's own draws are checked by their distribution.
The JAX package warps with its gather-free taps (``warp.py:146-191``), the
port with the bilinear gather; the two agree to float32 noise while the
flow stays inside the taps' window, as it does at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.dsp import warp as jax_warp
from asf_tpu.dsp.specaugment import spec_augment_single
from asf_tpu_torch.dsp import specaugment, warp

T, F = 64, 32


def _jax_draws(key, num_freq_masks=2, num_time_masks=2, freq_mask_param=27,
               time_mask_param=25, warp_param=5):
    """The integers ``spec_augment_single(key, (T, F) spec)`` draws."""
    keys = jax.random.split(key, 1 + num_freq_masks + num_time_masks)
    k1, k2 = jax.random.split(keys[0])
    out = {
        "warp_pos": jax.random.randint(k1, (), warp_param, T - warp_param),
        "warp_dist": jax.random.randint(k2, (), -warp_param, warp_param),
    }
    for name, first, n, param, size in (("freq", 1, num_freq_masks, freq_mask_param, F),
                                        ("time", 1 + num_freq_masks, num_time_masks,
                                         time_mask_param, T)):
        triples = []
        for i in range(n):
            m1, m2, m3 = jax.random.split(keys[first + i], 3)
            width = jax.random.randint(m1, (), 0, param)
            start = jax.random.randint(m2, (), 0, jnp.maximum(size - width, 1))
            end = jax.random.randint(m3, (), start, jnp.maximum(start + width, start + 1))
            triples.append((int(width), int(start), int(end)))
        out[name] = triples
    return out


def _stack(draws):
    """Per-sample JAX draws -> the port's batched draws."""
    out = {k: torch.tensor([int(d[k]) for d in draws]) for k in ("warp_pos", "warp_dist")}
    for name in ("freq", "time"):
        arr = torch.tensor([d[name] for d in draws])  # (B, n, 3)
        out[name] = tuple(arr[:, :, j] for j in range(3))
    return out


def _specs(seed, batch):
    return np.random.default_rng(seed).standard_normal((batch, T, F)).astype(np.float32)


def _compare(seed, batch, **kw):
    specs = _specs(seed, batch)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    params = {k: v for k, v in kw.items() if k.endswith(("_masks", "_param"))}
    draws = [_jax_draws(k, **params) for k in keys]
    want = np.stack([np.asarray(spec_augment_single(k, jnp.asarray(s), **kw))
                     for k, s in zip(keys, specs)])
    got = specaugment.apply(
        torch.from_numpy(specs), _stack(draws), warp_param=kw.get("warp_param", 5),
        enable_warp=kw.get("enable_warp", True),
        faithful_warp_bug=kw.get("faithful_warp_bug", True),
    ).numpy()
    return got, want, draws, specs


def test_masks_match_jax():
    got, want, _, specs = _compare(1, 6, enable_warp=False)
    assert not np.array_equal(want, specs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)  # the fills: means in another order


@pytest.mark.parametrize("faithful", [True, False])
def test_warp_and_masks_match_jax(faithful):
    got, want, _, _ = _compare(2, 6, faithful_warp_bug=faithful)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_zero_width_draw_ends_the_stage():
    """Widths from [0, 2): a zero-width draw skips that mask and every later
    one of its stage (``specaugment.py:44-47``), on both sides."""
    got, want, draws, specs = _compare(3, 12, enable_warp=False, freq_mask_param=2,
                                       time_mask_param=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    quirk = [b for b, d in enumerate(draws) if d["freq"][0][0] == 0 and d["freq"][1][0] == 1
             and d["time"][0][0] == 0]
    assert quirk, "no sample drew a zero width first"
    for b in quirk:  # the second frequency mask would have been live
        np.testing.assert_array_equal(got[b], specs[b])


def test_interpolate_spline_matches_jax():
    """One control point, the closed form of ``asf_tpu/dsp/warp.py:58-71``."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 40, (1, 2)).astype(np.float32)
    vals = rng.standard_normal((1, 2)).astype(np.float32) * 3
    queries = rng.uniform(0, 40, (200, 2)).astype(np.float32)
    want = np.asarray(jax_warp.interpolate_spline(*map(jnp.asarray, (pts, vals, queries))))
    got = warp.interpolate_spline(*(torch.from_numpy(x)[None] for x in (pts, vals, queries)))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="one control point"):
        warp.interpolate_spline(*(torch.ones(1, 3, d) for d in (2, 2, 2)))


def test_bilinear_and_sparse_warp_match_jax():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((F, T)).astype(np.float32)
    queries = rng.uniform(-3, T + 3, (300, 2)).astype(np.float32)  # past every edge
    queries[:, 0] = rng.uniform(-3, F + 3, 300)
    want = np.asarray(jax_warp.interpolate_bilinear(jnp.asarray(img), jnp.asarray(queries)))
    got = warp.interpolate_bilinear(torch.from_numpy(img)[None], torch.from_numpy(queries)[None])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-6)

    src = np.asarray([[F // 2, 30.0]], np.float32)
    dst = src + np.asarray([[0.0, -4.0]], np.float32)
    want = np.asarray(jax_warp.sparse_image_warp(*map(jnp.asarray, (img, src, dst))))
    got = warp.sparse_image_warp(*(torch.from_numpy(x)[None] for x in (img, src, dst)))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-5)


def test_draws_by_distribution():
    n = 20000
    g = torch.Generator().manual_seed(0)
    d = specaugment.draw(n, T, F, g)
    assert d["warp_pos"].min() >= 5 and d["warp_pos"].max() < T - 5
    assert d["warp_dist"].min() >= -5 and d["warp_dist"].max() < 5
    assert abs(d["warp_pos"].float().mean().item() - (5 + T - 6) / 2) < 0.5
    assert abs(d["warp_dist"].float().mean().item() - (-0.5)) < 0.1
    for (width, start, end), param, size in ((d["freq"], 27, F), (d["time"], 25, T)):
        assert width.shape == (n, 2)
        assert width.min() >= 0 and width.max() == param - 1
        span = (size - width).clamp(min=1)
        assert (start >= 0).all() and (start < span).all()
        assert (end >= start).all() and (end < start + width.clamp(min=1)).all()
        # uniform means: width over [0, param), start given width, end - start given width
        assert abs(width.float().mean().item() - (param - 1) / 2) < 0.2
        assert abs((start - (span - 1) / 2).float().mean().item()) < 0.2
        assert abs((end - start - (width.clamp(min=1) - 1) / 2).float().mean().item()) < 0.2
    again = specaugment.draw(n, T, F, torch.Generator().manual_seed(0))
    assert torch.equal(again["freq"][1], d["freq"][1])


def test_spec_augment_keeps_shape_and_changes_values():
    spec = torch.from_numpy(_specs(9, 4))
    out = specaugment.spec_augment(spec, torch.Generator().manual_seed(1))
    assert out.shape == spec.shape and torch.isfinite(out).all()
    assert not torch.equal(out, spec)
