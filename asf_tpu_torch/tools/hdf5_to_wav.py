"""Export an EPIC-KITCHENS HDF5 archive as the port's per-video wav files.

    python -m asf_tpu_torch.tools.hdf5_to_wav EPIC_audio.hdf5 OUTPUT_DIR \\
        [--sampling_rate 24000]

For a user who wants the audio of an archive (one dataset a video,
``tools/wav_to_hdf5.py``) as files: each dataset becomes
``OUTPUT_DIR/<video_id>.wav``, mono 16-bit PCM at ``--sampling_rate``
(``AUDIO_DATA.SAMPLING_RATE``). An int16 dataset is written as it is; a
float one as ``round(x * 32768)`` clipped to int16, which gives back bit
for bit the samples of a 16-bit source that the JAX package's reader
scaled by 1/32768. The archive is read through the port's own reader
(``data/hdf5.py``, no h5py); the port also reads it directly as
``EPICKITCHENS.AUDIO_DATA_FILE``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import hdf5


def to_int16(samples: np.ndarray) -> np.ndarray:
    """Samples as 16-bit PCM: int16 as they are, floats in [-1, 1) scaled by 32768."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        return samples
    return np.clip(np.round(samples.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16)


def main(argv=None):
    from scipy.io import wavfile

    parser = argparse.ArgumentParser()
    parser.add_argument("input_file", help="The HDF5 archive (one dataset a video)")
    parser.add_argument("output_dir", help="Directory to write <video_id>.wav files into")
    parser.add_argument("--sampling_rate", type=int, default=24000)
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    archive = hdf5.Archive(args.input_file)  # raises for a dataset of another rank
    try:
        for name in archive.names():
            wavfile.write(os.path.join(args.output_dir, f"{name}.wav"), args.sampling_rate,
                          to_int16(archive.read(name)))
            print(name)
    finally:
        archive.close()


if __name__ == "__main__":
    main()
