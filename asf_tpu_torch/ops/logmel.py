"""The log-mel kernels of the port: wrappers, plain versions, launch counts.

Three hand-written CUDA kernels (``csrc/logmel.cu``) replace the three
Pallas kernels of ``asf_tpu/ops/logmel_pallas.py``:

* ``logmel_f32`` replaces ``_partial_mel`` (``_kernel``, :264-310) and the
  caller's sum over frequency tiles and log (:458-464): the float32 parity
  path (``DSP_PRECISION="HIGHEST"``). It sums the frequency chunks in
  registers and writes no ``(nk, rows, m)`` partial stack.
* ``logmel_bf16`` replaces ``_resident_logmel`` (``_kernel_resident``,
  :190-261): the production path (``"BFLOAT16"``). bf16 waveform, basis and
  mel matrix, float32 accumulation, the magnitude rounded to bf16 before the
  mel product (:221), the log inside the kernel. Both products run on the
  tensor cores (``wgmma``).
* ``logmel_bf16_wide`` replaces ``_hopblock_logmel`` (``_kernel_hopblock``,
  :99-187): the same bf16 function, chosen for wide window supports
  (``dsp/logmel.py:LogMelParams.hopblock``), and the same kernel as
  ``logmel_bf16``: K3's hop-blocked layout, a TPU artefact, does not exist
  here.

All three compute, for frame ``t`` of sample ``b`` (``x`` the un-padded
waveform, zero outside ``[0, S)``)::

    frame[t][c] = x[b, t*hop + off + c]                  c < ksup
    out[b, t]   = log(|frame[t] @ (w_cos, w_sin)| @ mel + eps)[:n_mels]

with ``off = s0a - n_fft//2``: the librosa centre padding and the
window-support trim in one index, so neither the Pallas ``frame_waveform``
pre-pass nor a frame tensor in device memory exists on the card.

What bounds them on the H100 is operations, not bytes: ~1.31 MFLOP per
frame at the flagship geometry (8.66 MFLOP at a 2048-tap support) against
~1.5 KB moved. The design notes are
in the CUDA source. There is no single PyTorch call for this function
(``torch.stft`` has no support trim and no mel or log), so the kernels have
no library yardstick.

A wrapper validates its arguments, then takes the plain version for CPU
tensors and launches its kernel for CUDA tensors. Each launch adds one to
the wrapper's ``launches`` count; nothing else does. No kernel has a
backward (nor have K1-K3): a wrapper raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

# The padded weight layout the kernels read (csrc/logmel.cu kChunk, kMels)
# and ``LogMelParams`` builds: basis width a multiple of FREQ_CHUNK, mel
# matrix MEL_WIDTH columns wide. Whether a support fits the kernel's shared
# memory is decided by the launch, which returns the CUDA error.
FREQ_CHUNK = 128
MEL_WIDTH = 128
# Terms of one tensor-core partial sum in the bf16 kernel (a wgmma k-step).
TC_GROUP = 16


def frames_of(x: torch.Tensor, ksup: int, hop: int, off: int, n_frames: int) -> torch.Tensor:
    """(B, S) -> (B, n_frames, ksup) view with frame[t][c] = x[t*hop + off + c]."""
    need = (n_frames - 1) * hop + ksup
    left = max(0, -off)
    x = x[:, max(0, off):]
    x = F.pad(x, (left, max(0, need - left - x.shape[1])))[:, :need]
    return x.unfold(1, ksup, hop)


def _toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = s.float()
    return torch.where(f.double().abs() > s.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tc_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over K with the rounding points of the bf16 kernel: the sum
    of each group of ``TC_GROUP`` consecutive terms rounded toward zero to
    float32 (what one wgmma with bf16 operands and a fresh float32
    accumulator returns), and these partial sums added in order in float32
    from zero. A model of the kernel's arithmetic, not its plain version
    (``logmel_bf16_tc_model`` is the front end built on it).

    ``a`` and ``b`` hold bf16 values, whose products have 16 significant
    bits. float64 sums a group exactly while the exponents of its products
    span fewer than ~33 binades (53 bits less 16, less 4 for the carries of
    16 terms); wider, float64 rounds first and the rounding toward zero
    after it may land one float32 step off. Waveform, basis and mel weights
    are bounded, but a magnitude near zero beside a large one can exceed
    that span in the mel product."""
    out = torch.zeros(*a.shape[:-1], b.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[-1], TC_GROUP):
        out += _toward_zero(a[..., k0:k0 + TC_GROUP].double() @ b[k0:k0 + TC_GROUP].double())
    return out


def _plain(wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps, round_mag,
           matmul=torch.matmul):
    frames = frames_of(wave.float(), w_cos.shape[0], hop, off, n_frames)
    re = matmul(frames, w_cos.float())
    im = matmul(frames, w_sin.float())
    mag = torch.sqrt(re * re + im * im)
    if round_mag:
        mag = mag.to(torch.bfloat16).float()
    return torch.log(matmul(mag, mel_w.float()) + eps)[..., :n_mels]


def logmel_f32_plain(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6):
    """Plain PyTorch version of ``logmel_f32`` (float32 products; TF32 must be off)."""
    return _plain(wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps, False)


def logmel_bf16_plain(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6):
    """Plain PyTorch version of ``logmel_bf16``: float32 products of the bf16
    inputs (TF32 must be off), the magnitude rounded to bf16 before the mel
    product."""
    return _plain(wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps, True)


def logmel_bf16_tc_model(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6):
    """``logmel_bf16``'s function summed at the bf16 kernel's rounding points
    (``tc_matmul``; float64 products, so slow): a model of the kernel, not
    its plain version."""
    return _plain(wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps, True, tc_matmul)


# K3 computes K2's function: one plain version serves both.
logmel_bf16_wide_plain = logmel_bf16_plain


def _check(wave, w_cos, w_sin, mel_w, dtype, hop, n_frames, n_mels):
    for name, t in (("wave", wave), ("w_cos", w_cos), ("w_sin", w_sin), ("mel_w", mel_w)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != wave.device:
            raise ValueError(f"{name} is on {t.device}, wave on {wave.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the log-mel kernels have no backward")
        if name != "wave" and t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")  # vector loads of weight rows
    if wave.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {wave.device}")
    if wave.dim() != 2:
        raise ValueError(f"wave must be (batch, samples), got {tuple(wave.shape)}")
    ksup, kf = w_cos.shape
    if tuple(w_sin.shape) != (ksup, kf):
        raise ValueError(f"w_sin {tuple(w_sin.shape)} differs from w_cos {(ksup, kf)}")
    if kf % FREQ_CHUNK or tuple(mel_w.shape) != (kf, MEL_WIDTH):
        raise ValueError(
            f"basis width {kf} must be a multiple of {FREQ_CHUNK} and mel_w "
            f"({kf}, {MEL_WIDTH}); got mel_w {tuple(mel_w.shape)}"
        )
    if not 0 < n_mels <= MEL_WIDTH or n_frames < 1 or hop < 1:
        raise ValueError(f"need 0 < n_mels <= {MEL_WIDTH}, n_frames >= 1 and hop >= 1")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("logmel")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.logmel_f32, lib.logmel_bf16, lib.logmel_bf16_wide):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.logmel_tc_frames_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.logmel_tc_frames_per_block.restype = ctypes.c_int
    lib.logmel_error_string.argtypes = [ctypes.c_int]
    lib.logmel_error_string.restype = ctypes.c_char_p
    return lib


def tc_frames_per_block(hop: int, ksup: int) -> int:
    """Frames per block of the bf16 kernel at this hop and support on the
    current CUDA device: 128, or fewer where the span of a wide hop would not
    fit the block's shared memory."""
    return _lib().logmel_tc_frames_per_block(hop, ksup)


def _launch(symbol, wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps):
    batch, n_samples = wave.shape
    ksup, kf = w_cos.shape
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=wave.device)
    lib = _lib()
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol)(
            wave.data_ptr(), w_cos.data_ptr(), w_sin.data_ptr(), mel_w.data_ptr(),
            out.data_ptr(), batch, n_samples, n_frames, hop, off, ksup, kf, n_mels,
            eps, stream,
        )
    if err:
        raise RuntimeError(f"{symbol} launch failed: {lib.logmel_error_string(err).decode()}")
    return out


def _wrapper(symbol, dtype, plain, doc, reference=None):
    """The wrapper of kernel ``symbol``: checks its arguments, takes ``plain``
    for CPU tensors, launches the kernel for CUDA tensors and counts it.
    ``reference`` (default ``plain``) is the plain PyTorch front end that
    sums as the kernel does, which ``chip_smoke.py`` holds the eval
    probabilities to."""

    def wrapper(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6):
        _check(wave, w_cos, w_sin, mel_w, dtype, hop, n_frames, n_mels)
        if wave.device.type == "cpu":
            return plain(wave, w_cos, w_sin, mel_w, hop=hop, off=off, n_frames=n_frames,
                         n_mels=n_mels, eps=eps)
        out = _launch(symbol, wave, w_cos, w_sin, mel_w, hop, off, n_frames, n_mels, eps)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = symbol
    wrapper.__doc__ = doc
    wrapper.launches = 0
    wrapper.reference = reference or plain
    return wrapper


logmel_f32 = _wrapper("logmel_f32", torch.float32, logmel_f32_plain, """\
(B, S) float32 waveform -> (B, n_frames, n_mels) float32 log-mel.

``w_cos``/``w_sin`` are the (ksup, kf) support rows of the windowed DFT
basis, ``mel_w`` the (kf, 128) mel matrix, zero-padded.""")
logmel_bf16 = _wrapper("logmel_bf16", torch.bfloat16, logmel_bf16_plain,
                       "The same function on a bf16 waveform, basis and mel matrix; float32 out.",
                       logmel_bf16_tc_model)
logmel_bf16_wide = _wrapper("logmel_bf16_wide", torch.bfloat16, logmel_bf16_wide_plain,
                            "``logmel_bf16``'s function and kernel, under K3's symbol: the "
                            "launch for wide window supports.", logmel_bf16_tc_model)
