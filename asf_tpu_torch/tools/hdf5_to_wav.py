"""Export an EPIC-KITCHENS HDF5 archive as the port's per-video wav files.

    python -m asf_tpu_torch.tools.hdf5_to_wav EPIC_audio.hdf5 OUTPUT_DIR \\
        [--sampling_rate 24000]

For a user who holds only the JAX package's archive (one dataset a video,
``tools/wav_to_hdf5.py``): each dataset becomes ``OUTPUT_DIR/<video_id>.wav``,
mono 16-bit PCM at ``--sampling_rate`` (``AUDIO_DATA.SAMPLING_RATE``), the
directory ``EPICKITCHENS.AUDIO_DATA_FILE`` names for the port. An int16
dataset is written as it is; a float one as ``round(x * 32768)`` clipped to
int16, which gives back bit for bit the samples of a 16-bit source that the
JAX package's reader scaled by 1/32768. A host tool: ``h5py`` is imported in
``main()``, and the card's machine has none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def to_int16(samples: np.ndarray) -> np.ndarray:
    """Samples as 16-bit PCM: int16 as they are, floats in [-1, 1) scaled by 32768."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        return samples
    return np.clip(np.round(samples.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16)


def main(argv=None):
    import h5py
    from scipy.io import wavfile

    parser = argparse.ArgumentParser()
    parser.add_argument("input_file", help="The HDF5 archive (one dataset a video)")
    parser.add_argument("output_dir", help="Directory to write <video_id>.wav files into")
    parser.add_argument("--sampling_rate", type=int, default=24000)
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    with h5py.File(args.input_file, "r") as f:
        for name in sorted(f):
            data = f[name][()]
            if data.ndim != 1:
                raise ValueError(f"{name}: a mono dataset is (samples,), got {data.shape}")
            wavfile.write(os.path.join(args.output_dir, f"{name}.wav"), args.sampling_rate,
                          to_int16(data))
            print(name)


if __name__ == "__main__":
    main()
