"""Vectorised, bit-identical replay of the loader's per-item draws.

Copy of ``asf_tpu/data/fast_rng.py`` (numpy only). Every train or val item
places its clip with
``np.random.default_rng(SeedSequence([RNG_SEED, epoch, index])).uniform(0, delta)``
(``sampling.item_rng``). Building a ``SeedSequence`` and a ``Generator``
costs tens of microseconds of interpreter time an item; this module replays
the same derivation for a whole batch of indices in a few numpy calls:

  * ``SeedSequence`` entropy pooling (numpy's ``bit_generator.pyx``):
    hashmix and mix over a 4-word uint32 pool, vectorised over items;
  * ``PCG64`` seeding (numpy's ``pcg64.c``, ``pcg_setseq_128_srandom_r``):
    the 128-bit LCG state as (hi, lo) uint64 pairs;
  * the XSL-RR 128/64 output function and ``next_double``
    ((u64 >> 11) * 2^-53), which ``Generator.uniform(0, delta)`` scales.

``tests/test_torch_port_data.py`` holds it bit for bit to the scalar path
and to the JAX package's copy over seeds, epochs, indices and deltas.
PCG64 and ``SeedSequence`` streams fall under numpy's stream-compatibility
policy.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_U64 = np.uint64

# SeedSequence pooling constants (numpy/random/bit_generator.pyx).
_POOL_SIZE = 4
_INIT_A = _U32(0x43B0D7E5)
_MULT_A = _U32(0x931E8875)
_INIT_B = _U32(0x8B51F9DD)
_MULT_B = _U32(0x58F38DED)
_MIX_MULT_L = _U32(0xCA01F9DD)
_MIX_MULT_R = _U32(0x4973F715)
_XSHIFT = _U32(16)

# PCG64 128-bit LCG multiplier (numpy/random/src/pcg64/pcg64.h).
_PCG_MULT_HI = _U64(2549297995355413924)
_PCG_MULT_LO = _U64(4865540595714422341)

_MASK32 = _U64(0xFFFFFFFF)
_SH32 = _U64(32)


def _hashmix(value: np.ndarray, hash_const: np.ndarray):
    """uint32 hashmix; ``hash_const`` is a same-shape array updated in place."""
    value = (value ^ hash_const).astype(_U32, copy=False)
    hash_const *= _MULT_A
    value = (value * hash_const).astype(_U32, copy=False)
    value ^= value >> _XSHIFT
    return value


def _mix(x: np.ndarray, y: np.ndarray):
    result = (x * _MIX_MULT_L - y * _MIX_MULT_R).astype(_U32, copy=False)
    result ^= result >> _XSHIFT
    return result


def _seed_pool(entropy_cols: list[np.ndarray]) -> np.ndarray:
    """Vectorized SeedSequence.mix_entropy for per-item entropy rows.

    ``entropy_cols``: one uint32 array per entropy word (all the same
    shape) — e.g. ``[seed, epoch, index]``. Returns the (n, 4) uint32 pool.
    Requires len(entropy_cols) <= pool size 4 (ours is 3); the trailing
    remaining-entropy loop of the scalar algorithm is then empty.
    """
    assert len(entropy_cols) <= _POOL_SIZE
    n = entropy_cols[0].shape[0]
    hash_const = np.full((n,), _INIT_A, _U32)
    pool = np.empty((_POOL_SIZE, n), _U32)
    zeros = np.zeros((n,), _U32)
    for i in range(_POOL_SIZE):
        src = entropy_cols[i] if i < len(entropy_cols) else zeros
        pool[i] = _hashmix(src.astype(_U32, copy=False), hash_const)
    for i_src in range(_POOL_SIZE):
        for i_dst in range(_POOL_SIZE):
            if i_src != i_dst:
                pool[i_dst] = _mix(pool[i_dst], _hashmix(pool[i_src], hash_const))
    return pool


def _generate_state8(pool: np.ndarray) -> np.ndarray:
    """SeedSequence.generate_state(4, uint64) -> (8, n) uint32 words."""
    n = pool.shape[1]
    hash_const = np.full((n,), _INIT_B, _U32)
    out = np.empty((8, n), _U32)
    for i_dst in range(8):
        data_val = pool[i_dst % _POOL_SIZE] ^ hash_const
        hash_const *= _MULT_B
        data_val = (data_val * hash_const).astype(_U32, copy=False)
        data_val ^= data_val >> _XSHIFT
        out[i_dst] = data_val
    return out


def _mul64_128(a: np.ndarray, b: np.ndarray):
    """Full 64x64 -> 128-bit product as (hi, lo) uint64 arrays."""
    a0 = a & _MASK32
    a1 = a >> _SH32
    b0 = b & _MASK32
    b1 = b >> _SH32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = (p00 >> _SH32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((mid & _MASK32) << _SH32)
    hi = a1 * b1 + (p01 >> _SH32) + (p10 >> _SH32) + (mid >> _SH32)
    return hi, lo


def _step128(s_hi, s_lo, inc_hi, inc_lo):
    """One PCG LCG step: state = state * MULT + inc (mod 2^128)."""
    hi, lo = _mul64_128(s_lo, _PCG_MULT_LO)
    hi = hi + s_lo * _PCG_MULT_HI + s_hi * _PCG_MULT_LO
    lo2 = lo + inc_lo
    hi = hi + inc_hi + (lo2 < lo).astype(_U64)
    return hi, lo2


def bulk_pcg64_state(seed: int, epoch: int, indices: np.ndarray):
    """Vectorized PCG64 state for ``item_rng(seed, epoch, index)`` per index.

    Returns (state_hi, state_lo, inc_hi, inc_lo) uint64 arrays positioned
    exactly where a fresh ``default_rng`` is before its first draw.
    """
    indices = np.asarray(indices)
    n = indices.shape[0]
    if not (0 <= int(seed) < 2**32 and 0 <= int(epoch) < 2**32):
        raise ValueError("seed/epoch outside uint32 — scalar path required")
    if n and (int(indices.min()) < 0 or int(indices.max()) >= 2**32):
        # The scalar SeedSequence raises for negatives and SPLITS >=2**32
        # ints into two entropy words; a silent uint32 wrap here would
        # diverge from it. Mirror the seed/epoch guard instead.
        raise ValueError("indices outside uint32 — scalar path required")
    cols = [
        np.full((n,), _U32(seed), _U32),
        np.full((n,), _U32(epoch), _U32),
        indices.astype(_U32),
    ]
    words = _generate_state8(_seed_pool(cols)).astype(_U64)
    # uint32 pairs view as little-endian uint64: word64[k] = w[2k] | w[2k+1]<<32
    w64 = [words[2 * k] | (words[2 * k + 1] << _SH32) for k in range(4)]
    # pcg64_set_seed: seed = (hi=w64[0], lo=w64[1]), inc = (hi=w64[2], lo=w64[3])
    seed_hi, seed_lo, i_hi, i_lo = w64
    # srandom: inc = (initseq << 1) | 1  (128-bit shift), state = 0; step;
    # state += initstate; step.
    inc_hi = (i_hi << _U64(1)) | (i_lo >> _U64(63))
    inc_lo = (i_lo << _U64(1)) | _U64(1)
    s_hi, s_lo = _step128(
        np.zeros((n,), _U64), np.zeros((n,), _U64), inc_hi, inc_lo
    )
    lo2 = s_lo + seed_lo
    s_hi = s_hi + seed_hi + (lo2 < s_lo).astype(_U64)
    s_hi, s_lo = _step128(s_hi, lo2, inc_hi, inc_lo)
    return s_hi, s_lo, inc_hi, inc_lo


def bulk_next64(state):
    """Advance each lane one step and return the XSL-RR 64-bit outputs.

    ``state`` is the (state_hi, state_lo, inc_hi, inc_lo) tuple from
    :func:`bulk_pcg64_state`; returns (new_state, out_u64).
    """
    s_hi, s_lo, inc_hi, inc_lo = state
    s_hi, s_lo = _step128(s_hi, s_lo, inc_hi, inc_lo)
    xored = s_hi ^ s_lo
    rot = (s_hi >> _U64(58)).astype(_U64)  # state >> 122 == hi >> 58
    out = (xored >> rot) | (xored << ((_U64(64) - rot) & _U64(63)))
    # rot == 0 lanes: (x << 64) is UB-ish in C but numpy computes x << 0 via
    # the mask above, giving x | x = x — correct by construction.
    return (s_hi, s_lo, inc_hi, inc_lo), out


def bulk_first_uniform(seed: int, epoch: int, indices: np.ndarray,
                       deltas: np.ndarray) -> np.ndarray:
    """``item_rng(seed, epoch, i).uniform(0, delta_i)`` for every lane,
    bit-identical to the scalar path (float64)."""
    _, u64 = bulk_next64(bulk_pcg64_state(seed, epoch, indices))
    d = (u64 >> _U64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
    return np.asarray(deltas, np.float64) * d
