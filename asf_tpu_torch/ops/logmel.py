"""The log-mel kernels of the port: wrappers, plain versions, launch counts.

Three hand-written CUDA kernels (``csrc/logmel.cu``) replace the three
Pallas kernels of ``asf_tpu/ops/logmel_pallas.py``:

* ``logmel_f32`` replaces ``_partial_mel`` (``_kernel``, :264-310) and the
  caller's sum over frequency tiles and log (:458-464): the float32 parity
  path (``DSP_PRECISION="HIGHEST"``), IEEE float32 FMA on the CUDA cores.
  A block owns one sample, 128 frames and a slice of the frequencies
  (``f32_plan``). With one slice it sums the frequency chunks in registers
  and writes no ``(nk, rows, m)`` partial stack; at small batch the grid
  splits the frequencies, as the TPU kernel does, into a scratch stack that
  a second kernel of the same call adds in a fixed order before the log.
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

What bounds them on the H100 is operations, not bytes: the function needs
~1.24 MFLOP per frame at the flagship geometry (the window's 239 nonzero
taps, 1,024 frequencies; 8.65 MFLOP at a 2047-tap support) against ~1.5 KB
moved. The design notes are
in the CUDA source. There is no single PyTorch call for this function
(``torch.stft`` has no support trim and no mel or log), so the kernels have
no library yardstick.

A wrapper validates its arguments, then takes the plain version for CPU
tensors and launches its kernel for CUDA tensors. Each call that launches
adds one to the wrapper's ``launches`` count (``logmel_f32``'s reduce
kernel belongs to its call); nothing else does. No kernel has a
backward (nor have K1-K3): a wrapper raises on an input that requires grad.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

# The padded weight layout the kernels read and ``LogMelParams`` builds:
# basis width a multiple of FREQ_CHUNK (logmel_f32's frequency chunk,
# csrc/logmel.cu kF32Freqs, and the unit of its frequency slices; the bf16
# kernel takes multiples of 32), mel matrix MEL_WIDTH (kMels) columns wide.
# Whether a support fits the kernel's shared memory is decided by the
# launch, which returns the CUDA error.
FREQ_CHUNK = 64
MEL_WIDTH = 128
# Terms of one tensor-core partial sum in the bf16 kernel (a wgmma k-step).
TC_GROUP = 16


def f32_plan(batch: int, n_frames: int, frames: int, kf: int, n_sms: int) -> int:
    """Frequency slices of a ``logmel_f32`` launch whose blocks take
    ``frames`` frames (``f32_frames_per_block``). Frame tiles x batch that
    leave SMs idle take as many slices as fill one wave of ``n_sms`` (at
    least one chunk of ``FREQ_CHUNK`` frequencies a slice); at least one wave
    of tiles takes one."""
    tiles = batch * -(-n_frames // frames)
    return max(1, min(kf // FREQ_CHUNK, n_sms // tiles))


def f32_slices(kf: int, splits: int) -> list[tuple[int, int]]:
    """The frequency range ``[k0, k1)`` of each slice, as the kernel splits
    ``kf`` (whole chunks of ``FREQ_CHUNK``, as evenly as they go)."""
    n = kf // FREQ_CHUNK
    return [(z * n // splits * FREQ_CHUNK, (z + 1) * n // splits * FREQ_CHUNK)
            for z in range(splits)]


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
    for fn in (lib.logmel_bf16, lib.logmel_bf16_wide):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.logmel_f32.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.logmel_f32.restype = ctypes.c_int
    for fn in (lib.logmel_tc_frames_per_block, lib.logmel_f32_frames_per_block):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.logmel_error_string.argtypes = [ctypes.c_int]
    lib.logmel_error_string.restype = ctypes.c_char_p
    return lib


def _frames(symbol: str, hop: int, ksup: int) -> int:
    lib = _lib()
    frames = getattr(lib, symbol)(hop, ksup)
    if frames < 1:
        raise RuntimeError(f"{symbol}: the device's shared-memory limit cannot be read: "
                           f"{lib.logmel_error_string(-frames).decode()}")
    return frames


def tc_frames_per_block(hop: int, ksup: int) -> int:
    """Frames per block of the bf16 kernel at this hop and support on the
    current CUDA device: 128, or fewer where the span of a wide hop would not
    fit the block's shared memory."""
    return _frames("logmel_tc_frames_per_block", hop, ksup)


def f32_frames_per_block(hop: int, ksup: int) -> int:
    """The same for ``logmel_f32``'s kernel, whose blocks decide it the same
    way (csrc/logmel.cu:frames_per_block)."""
    return _frames("logmel_f32_frames_per_block", hop, ksup)


@functools.cache
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def f32_device_plan(batch: int, n_frames: int, hop: int, ksup: int, kf: int,
                    device) -> tuple[int, int]:
    """``(frames, splits)`` of a ``logmel_f32`` launch on CUDA ``device``:
    frames a block and ``f32_plan``'s slices on the device's SM count."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with torch.cuda.device(index):
        frames = f32_frames_per_block(hop, ksup)
    return frames, f32_plan(batch, n_frames, frames, kf, _n_sms(index))


def _run(symbol, wave, *args):
    lib = _lib()
    with torch.cuda.device(wave.device):
        err = getattr(lib, symbol)(wave.data_ptr(), *args,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: {lib.logmel_error_string(err).decode()}")


def _launch_tc(symbol, wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps):
    batch, n_samples = wave.shape
    ksup, kf = w_cos.shape
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=wave.device)
    _run(symbol, wave, w_cos.data_ptr(), w_sin.data_ptr(), mel_w.data_ptr(), out.data_ptr(),
         batch, n_samples, n_frames, hop, off, ksup, kf, n_mels, eps)
    return out


def _launch_f32(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6, splits=None):
    """``logmel_f32``'s launch on CUDA tensors in ``splits`` frequency slices
    (default: the plan's). The wrapper checks the arguments and counts the
    launch; a caller that forces the slices (tests, the other branch in
    ``chip_smoke.py``) comes here and is not counted."""
    batch, n_samples = wave.shape
    ksup, kf = w_cos.shape
    if splits is None:
        splits = f32_device_plan(batch, n_frames, hop, ksup, kf, wave.device)[1]
    if not 1 <= splits <= kf // FREQ_CHUNK:
        raise ValueError(f"splits must be 1..{kf // FREQ_CHUNK}, got {splits}")
    out = torch.empty((batch, n_frames, n_mels), dtype=torch.float32, device=wave.device)
    part = (torch.empty((splits, batch, n_frames, n_mels), dtype=torch.float32,
                        device=wave.device) if splits > 1 else None)
    _run("logmel_f32", wave, w_cos.data_ptr(), w_sin.data_ptr(), mel_w.data_ptr(),
         out.data_ptr(), None if part is None else part.data_ptr(), batch, n_samples, n_frames,
         hop, off, ksup, kf, n_mels, eps, splits)
    return out


def _wrapper(symbol, dtype, plain, launch, doc):
    """The wrapper of kernel ``symbol``: checks its arguments, takes ``plain``
    for CPU tensors, launches the kernel for CUDA tensors and counts the call
    (one per call, whatever kernels the call launches)."""

    def wrapper(wave, w_cos, w_sin, mel_w, *, hop, off, n_frames, n_mels, eps=1e-6):
        _check(wave, w_cos, w_sin, mel_w, dtype, hop, n_frames, n_mels)
        geo = dict(hop=hop, off=off, n_frames=n_frames, n_mels=n_mels, eps=eps)
        if wave.device.type == "cpu":
            return plain(wave, w_cos, w_sin, mel_w, **geo)
        out = launch(wave, w_cos, w_sin, mel_w, **geo)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = symbol
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


logmel_f32 = _wrapper("logmel_f32", torch.float32, logmel_f32_plain, _launch_f32, """\
(B, S) float32 waveform -> (B, n_frames, n_mels) float32 log-mel.

``w_cos``/``w_sin`` are the (ksup, kf) support rows of the windowed DFT
basis, ``mel_w`` the (kf, 128) mel matrix, zero-padded.""")
logmel_bf16 = _wrapper("logmel_bf16", torch.bfloat16, logmel_bf16_plain,
                       functools.partial(_launch_tc, "logmel_bf16"),
                       "The same function on a bf16 waveform, basis and mel matrix; float32 out.")
logmel_bf16_wide = _wrapper("logmel_bf16_wide", torch.bfloat16, logmel_bf16_wide_plain,
                            functools.partial(_launch_tc, "logmel_bf16_wide"),
                            "``logmel_bf16``'s function and kernel, under K3's symbol: the "
                            "launch for wide window supports.")
