"""Extract mono 16-bit wav tracks from EPIC-KITCHENS videos with ffmpeg.

    python -m asf_tpu_torch.tools.extract_audio VIDEOS_DIR OUTPUT_DIR \\
        [--sampling_rate 24000] [--jobs 8]

Copy of ``asf_tpu/tools/extract_audio.py``: every ``*.MP4`` (any case)
under ``VIDEOS_DIR`` becomes ``OUTPUT_DIR/<name>.wav``, the per-video wav
files ``EPICKITCHENS.AUDIO_DATA_FILE`` names as a directory. Needs
``ffmpeg`` on the PATH; a host tool, run before training.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor


def ffmpeg_extraction(input_video: str, output_audio: str, sampling_rate: str) -> int:
    cmd = ["ffmpeg", "-y", "-i", input_video, "-vn", "-acodec", "pcm_s16le", "-ac", "1",
           "-ar", str(sampling_rate), output_audio]
    return subprocess.call(cmd)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("videos_dir", help="Directory of videos with audio")
    parser.add_argument("output_dir", help="Directory to save wav files")
    parser.add_argument("--sampling_rate", default="24000")
    parser.add_argument("--jobs", type=int, default=8, help="Parallel ffmpeg jobs")
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    tasks = []
    for root, _dirs, files in os.walk(args.videos_dir):
        for f in files:
            if f.upper().endswith(".MP4"):
                tasks.append((os.path.join(root, f),
                              os.path.join(args.output_dir, os.path.splitext(f)[0] + ".wav")))
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        list(pool.map(lambda t: ffmpeg_extraction(t[0], t[1], args.sampling_rate), tasks))


if __name__ == "__main__":
    main()
