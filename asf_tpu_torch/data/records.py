"""Audio records: views over annotation rows.

Copy of ``asf_tpu/data/records.py:21-86`` (``timestamp_to_sec``,
``AudioRecord``, ``EpicKitchensAudioRecord``) and ``:88-121``
(``EpicKitchensAudioRecordGRU``), and ``:125-144`` (the PDDL records, whose
labels add ``precs`` and ``posts``). The JAX records take a
DataFrame's ``(index, row)`` pair and read the narration id from the index;
these take one dict row that carries it under ``narration_id``
(``vggsound.read_annotations(path, index_key="narration_id")`` gives such
rows from a DataFrame and from a list of dicts alike). A PDDL row whose
``precs_vec`` or ``posts_vec`` is empty (its verb is not an action of the
domain, ``asf_tpu/state/dataset_prep.py:extend_data``) raises a
``ValueError`` naming its ``narration_id``; the JAX package fails later, in
``np.stack``.
"""

from __future__ import annotations

import time
from datetime import timedelta

import numpy as np


def timestamp_to_sec(timestamp: str) -> float:
    """'HH:MM:SS.ff' -> seconds (any number of fractional digits)."""
    time_parts = timestamp.split(".")
    base_time = time_parts[0]
    frac = time_parts[1].rstrip("0") if len(time_parts) > 1 else "0"
    if not frac:
        frac = "0"
    x = time.strptime(base_time, "%H:%M:%S")
    sec = float(
        timedelta(hours=x.tm_hour, minutes=x.tm_min, seconds=x.tm_sec).total_seconds()
    )
    return sec + int(frac) / (10 ** len(frac))


class AudioRecord:
    def __init__(self, row: dict, cfg):
        self.cfg = cfg
        self._index = str(row["narration_id"])
        self._series = row
        self._sampling_rate = cfg.AUDIO_DATA.SAMPLING_RATE

    @property
    def participant(self):
        return self._series["participant_id"]

    @property
    def untrimmed_video_name(self):
        return self._series["video_id"]

    @property
    def start_audio_sample(self) -> int:
        return int(round(timestamp_to_sec(self._series["start_timestamp"]) * self._sampling_rate))

    @property
    def end_audio_sample(self) -> int:
        return int(round(timestamp_to_sec(self._series["stop_timestamp"]) * self._sampling_rate))

    @property
    def num_audio_samples(self) -> int:
        return self.end_audio_sample - self.start_audio_sample

    @property
    def transformation(self) -> str:
        return self._series["transformation"] if "transformation" in self._series else "none"

    @property
    def label(self):
        raise NotImplementedError

    @property
    def metadata(self):
        return {"narration_id": self._index}


class EpicKitchensAudioRecord(AudioRecord):
    @property
    def label(self):
        return {
            "verb": self._series["verb_class"],
            "noun": self._series["noun_class"],
        }


class EpicKitchensAudioRecordGRU(EpicKitchensAudioRecord):
    """A record read as a chain of overlapping windows."""

    def __init__(self, row: dict, cfg):
        super().__init__(row, cfg)
        self._spectrogram_overlap = cfg.AUDIO_DATA.SPECTROGRAM_OVERLAP

    @property
    def length_in_s(self) -> float:
        return self.num_audio_samples / self._sampling_rate

    @property
    def num_spectrograms(self) -> int:
        """ceil((len - overlap) / (clip - overlap)), at least 1."""
        return int(np.ceil(max(
            (self.length_in_s - self._spectrogram_overlap)
            / (self.cfg.AUDIO_DATA.CLIP_SECS - self._spectrogram_overlap),
            1,
        )))

    @property
    def noun_embedding(self) -> np.ndarray:
        """The row's ``noun_embedding``, flattened; empty when it has none."""
        if "noun_embedding" in self._series:
            return np.asarray(self._series["noun_embedding"]).reshape(-1)
        return np.array([])


def _state_label(record: AudioRecord) -> dict:
    """verb, noun, and ``precs``/``posts`` (P,) float32 of ``record``'s row."""
    row = record._series
    label = {"verb": row["verb_class"], "noun": row["noun_class"]}
    for key in ("precs", "posts"):
        vec = np.asarray(row[f"{key}_vec"], np.float32).reshape(-1)
        if not vec.size:
            raise ValueError(
                f"narration {record._index}: empty {key}_vec (its verb is not an action of the "
                "PDDL domain)")
        label[key] = vec
    return label


class EpicKitchensAudioRecordWithPDDL(EpicKitchensAudioRecord):
    @property
    def label(self):
        return _state_label(self)


class EpicKitchensAudioRecordGRUwithPDDL(EpicKitchensAudioRecordGRU):
    @property
    def label(self):
        return _state_label(self)
