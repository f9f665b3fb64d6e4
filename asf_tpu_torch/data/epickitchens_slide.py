"""Sliding-window test set over untrimmed EPIC-KITCHENS-100 videos.

Counterpart of ``asf_tpu/data/epickitchens_slide.py:37-260``
(``EpicKitchensSlide``), built on the port's ``EpicKitchens`` tables and
read without pandas: the annotations through
``vggsound.read_annotations(path, index_key="narration_id")``, the video
durations (``EPICKITCHENS.VIDEO_DURS``, a csv with ``video_id`` and
``duration`` columns) through ``csv``. Test split only; each window is one
item, read as a test row's view 0 of ``TEST.NUM_ENSEMBLE_VIEWS`` (the JAX
records' temporal index 0). Three modes (``TEST.SLIDE``):

* whole video (``INSIDE_ACTION_BOUNDS`` and ``PER_ACTION_INSTANCE`` off):
  windows of ``WIN_SIZE`` s every ``HOP_SIZE`` s over each video of the
  csv that has annotations, in the csv's order, while the window's middle
  lies before the video's end (its end clipped there). A window's labels
  are the first ``MAX_OVERLAP`` annotations of its video, in (start, stop)
  order, whose span holds its middle, the first repeated in the unused
  slots; a window that no annotation holds keeps -1 in every slot. Labels
  are (rows, 4) tables. Quirk of the reference, kept: every window of a
  video carries the video's row number among the csv rows kept as its
  ``narration_id``.
* action bounds (``INSIDE_ACTION_BOUNDS``): windows of ``WIN_SIZE`` s every
  ``HOP_SIZE`` s inside each annotation while the window's middle lies
  inside it; an action shorter than a window is one item as it is.
* per instance (both on): one item an annotation.

``PER_ACTION_INSTANCE`` without ``INSIDE_ACTION_BOUNDS`` raises
``NotImplementedError``, as in the JAX package. ``EPICKITCHENS.SINGLE_BATCH``
keeps the first ``TEST.BATCH_SIZE`` windows (whole video) or annotation
rows (the other modes). In the device store (``data/device_store.py``;
the JAX package's ``:139-215``) the whole-video mode stores each video once,
as one segment from its first sample to the larger of its length and the
reach of its windows' clips (zeros past its end), and its windows' clips
are offsets into it: the parent's per-window segments would store a video
``WIN_SIZE / HOP_SIZE`` times. The other modes keep the parent's segments.
"""

from __future__ import annotations

import csv
import datetime
import os

import numpy as np

from .build import register_dataset
from .epickitchens import EpicKitchens
from .records import timestamp_to_sec
from .vggsound import read_annotations

MAX_OVERLAP = 4  # annotations a whole-video window keeps (the reference's empirical maximum)


def _ts(seconds: float) -> str:
    return (datetime.datetime.min + datetime.timedelta(seconds=seconds)).strftime(
        "%H:%M:%S.%f")


def read_video_durations(path: str) -> list[tuple[str, float]]:
    """(video_id, duration s) of each row of the csv at ``path``, in its order."""
    with open(path, newline="") as f:
        return [(row["video_id"], float(row["duration"])) for row in csv.DictReader(f)]


@register_dataset("EpicKitchensSlide")
class EpicKitchensSlide(EpicKitchens):
    def __init__(self, cfg, mode: str):
        if mode != "test":
            raise ValueError(f"Split '{mode}' not supported for {type(self).__name__}: it "
                             "only tests")
        super().__init__(cfg, mode)

    def _test_views(self) -> int:
        return 1

    def _whole_video(self) -> bool:
        slide = self.cfg.TEST.SLIDE
        return not slide.PER_ACTION_INSTANCE and not slide.INSIDE_ACTION_BOUNDS

    def _store_segment(self, row: int) -> tuple[int, int]:
        if not self._whole_video():
            return super()._store_segment(row)
        ends = getattr(self, "_video_ends", None)
        if ends is None:
            ends = self._video_ends = {}
            reach = np.maximum(self._start + self.clip_samples, self._start + self._num)
            for video, r in zip(self._video, reach.tolist()):
                ends[video] = max(ends.get(video, 0), self._video_len(video), r)
        return 0, ends[self._video[row]]

    def _records(self, files: list[str]) -> list:
        slide = self.cfg.TEST.SLIDE
        if not slide.PER_ACTION_INSTANCE and not slide.INSIDE_ACTION_BOUNDS:
            rows = self._whole_video_rows(files)
        elif slide.INSIDE_ACTION_BOUNDS:
            rows = self._action_rows(files, per_instance=slide.PER_ACTION_INSTANCE)
        else:
            raise NotImplementedError("Only whole video mode is supported for now")
        return [self.record_type(row, self.cfg) for row in rows]

    def _whole_video_rows(self, files: list[str]) -> list[dict]:
        cfg = self.cfg
        win, hop = cfg.TEST.SLIDE.WIN_SIZE, cfg.TEST.SLIDE.HOP_SIZE
        durations = read_video_durations(
            os.path.join(cfg.EPICKITCHENS.ANNOTATIONS_DIR, cfg.EPICKITCHENS.VIDEO_DURS))
        out = []
        for f in files:
            rows = sorted(read_annotations(f, index_key="narration_id"),
                          key=lambda r: (r["video_id"], r["start_timestamp"], r["stop_timestamp"]))
            by_video: dict = {}
            for r in rows:
                by_video.setdefault(r["video_id"], []).append(r)
            kept = [(v, d) for v, d in durations if v in by_video]
            for i, (video, duration) in enumerate(kept):
                windows = []
                start, end = 0.0, win
                while (start + end) / 2 < duration:
                    end = min(end, duration)
                    if cfg.EPICKITCHENS.SINGLE_BATCH and (
                            len(out) + len(windows) >= cfg.TEST.BATCH_SIZE):
                        break
                    windows.append({"narration_id": i, "video_id": video,
                                    "start_timestamp": _ts(start), "stop_timestamp": _ts(end)})
                    start += hop
                    end = start + win
                _label_windows(windows, by_video[video])
                out += windows
        return out

    def _action_rows(self, files: list[str], per_instance: bool) -> list[dict]:
        cfg = self.cfg
        win, hop = cfg.TEST.SLIDE.WIN_SIZE, cfg.TEST.SLIDE.HOP_SIZE
        out = []
        for f in files:
            rows = read_annotations(f, index_key="narration_id")
            if cfg.EPICKITCHENS.SINGLE_BATCH:
                rows = rows[: cfg.TEST.BATCH_SIZE]
            for row in rows:
                start = timestamp_to_sec(row["start_timestamp"])
                action_end = timestamp_to_sec(row["stop_timestamp"])
                if per_instance or action_end - start < win:
                    out.append(row)
                    continue
                end = start + win
                while (start + end) / 2 <= action_end:
                    end = min(end, action_end)
                    out.append({**row, "start_timestamp": _ts(start), "stop_timestamp": _ts(end)})
                    start += hop
                    end = start + win
        return out


def _label_windows(windows: list[dict], annotations: list[dict]) -> None:
    """Sets each window's ``verb_class`` and ``noun_class`` (MAX_OVERLAP,)
    from the ``annotations`` of its video (in (start, stop) order) that
    hold its middle: the first MAX_OVERLAP of them, the first repeated in
    the unused slots; -1 in every slot where none does."""
    starts = np.asarray([timestamp_to_sec(a["start_timestamp"]) for a in annotations])
    stops = np.asarray([timestamp_to_sec(a["stop_timestamp"]) for a in annotations])
    verbs = np.asarray([a["verb_class"] for a in annotations])
    nouns = np.asarray([a["noun_class"] for a in annotations])
    mids = np.asarray([(timestamp_to_sec(w["start_timestamp"])
                        + timestamp_to_sec(w["stop_timestamp"])) / 2 for w in windows])
    inside = (starts[None, :] <= mids[:, None]) & (mids[:, None] <= stops[None, :])
    for w, hold in zip(windows, inside):
        hits = np.flatnonzero(hold)[:MAX_OVERLAP]
        if not hits.size:
            w["verb_class"] = np.full(MAX_OVERLAP, -1, np.int64)
            w["noun_class"] = np.full(MAX_OVERLAP, -1, np.int64)
            continue
        pad = np.concatenate([hits, np.repeat(hits[:1], MAX_OVERLAP - hits.size)])
        w["verb_class"] = verbs[pad].astype(np.int64)
        w["noun_class"] = nouns[pad].astype(np.int64)
