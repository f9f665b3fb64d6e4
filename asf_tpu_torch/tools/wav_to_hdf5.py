"""Pack per-video wav files into one EPIC-KITCHENS HDF5 archive.

    python -m asf_tpu_torch.tools.wav_to_hdf5 AUDIO_DIR OUTPUT_FILE.hdf5 \\
        [--sampling_rate 24000] [--jobs 8] [--chunk_seconds 10] [--int16]

Counterpart of ``asf_tpu/tools/wav_to_hdf5.py``: one dataset a video,
named by the wav file's basename, float32 (or raw 16-bit PCM with
``--int16``), in chunks of ``--chunk_seconds`` (``min(chunk, n)``
samples; an empty video contiguous) for region reads. The archive is what
both packages read as ``EPICKITCHENS.AUDIO_DATA_FILE``; it is written
through the port's own writer (``data/hdf5.py``, no h5py), and h5py reads
it as it reads the JAX package's tool's archive (``tools/hdf5_to_wav.py``
goes back to wav files).
"""

from __future__ import annotations

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data import hdf5


def load_audio(root: str, fname: str, target_sr: int, int16: bool = False):
    from ..data.vggsound import load_wav

    samples, sr = load_wav(os.path.join(root, fname), keep_int16=int16)
    assert sr == target_sr, f"Sampling rate of audio files should be {target_sr} ({fname})"
    assert samples.ndim == 1, f"Audio files should be mono ({fname})"
    if int16:
        assert samples.dtype == np.int16, (
            f"--int16 needs mono 16-bit PCM sources ({fname} is {samples.dtype})")
        return np.array(samples), os.path.splitext(fname)[0]
    return samples.astype(np.float32), os.path.splitext(fname)[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("audio_dir", help="Directory of wav files")
    parser.add_argument("output_file", help="Path of the HDF5 file to write")
    parser.add_argument("--sampling_rate", type=int, default=24000)
    parser.add_argument("--jobs", type=int, default=8)
    parser.add_argument("--chunk_seconds", type=float, default=10.0,
                        help="HDF5 chunk length in seconds (enables fast region reads)")
    parser.add_argument("--int16", action="store_true",
                        help="Store raw 16-bit PCM datasets (mono int16 wav sources)")
    args = parser.parse_args(argv)

    wavs = sorted(f for f in os.listdir(args.audio_dir) if f.endswith(".wav"))
    chunk = int(args.sampling_rate * args.chunk_seconds)
    with hdf5.Writer(args.output_file) as out, ThreadPoolExecutor(max_workers=args.jobs) as pool:
        # decoding runs at most 2 x jobs files ahead of the one writer
        window, queue_, it = max(2, 2 * args.jobs), deque(), iter(wavs)

        def refill():
            while len(queue_) < window:
                f = next(it, None)
                if f is None:
                    return
                queue_.append(pool.submit(load_audio, args.audio_dir, f, args.sampling_rate,
                                          args.int16))

        refill()
        while queue_:
            samples, video_name = queue_.popleft().result()
            refill()
            print(video_name)
            out.add(video_name, samples, min(chunk, len(samples)) if len(samples) else None)


if __name__ == "__main__":
    main()
