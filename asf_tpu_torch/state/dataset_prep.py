"""Offline EPIC-KITCHENS dataset preparation, without pandas.

Counterpart of ``asf_tpu/state/dataset_prep.py``: the original annotation
lists filtered to the chosen verbs (or all), the PDDL domain's actions as
``precs``/``posts`` and their vectors over the sorted attributes (written
to ``MODEL.PDDL_ATTRIBUTES`` as ``attributes.csv``, byte for byte the
pandas ``to_csv(index=False)`` file), a CLIP text embedding a noun, the
class-balancing augmentation planner, and the processed train and val
lists.

Differences from the JAX package, each on purpose:

* The processed lists are pickled **lists of dicts**, each row carrying its
  ``narration_id``, which the port's datasets and the card's machine (no
  pandas) read; the JAX package writes DataFrames indexed by it. The
  original lists are read with ``data/vggsound.py:read_annotations`` (a
  pickled DataFrame, which needs pandas installed to unpickle, or a list of
  dicts); the verb and noun csvs with ``csv``.
* The noun embeddings come from the pickled table ``STATE.NOUNS_EMBEDDINGS_FILE``
  (a DataFrame of one row a noun id, as the JAX package writes it, or a
  dict of vectors, as this module writes it), else from a CLIP text model
  already in the local ``transformers`` cache (``local_files_only``; nothing
  is downloaded), else from a fallback seeded from ``zlib.crc32`` of the
  noun's key. The JAX package seeds its fallback from ``hash()``, which
  changes with ``PYTHONHASHSEED``; this one gives the same vectors in every
  interpreter.

The planner draws in the JAX package's order from
``np.random.default_rng(RNG_SEED)``, so the transformations come out equal
row for row.
"""

from __future__ import annotations

import collections
import csv
import os
import pickle
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.transforms import get_transforms
from ..data.vggsound import read_annotations
from ..utils.logging import get_logger
from .pddl import parse_pddl

logger = get_logger(__name__)

CLIP_DIM = 512


def read_csv_rows(path: str) -> List[dict]:
    """The rows of a class csv (``id``, ``key``, ...), ``id`` as an int."""
    with open(path, newline="") as f:
        return [{**row, "id": int(row["id"])} for row in csv.DictReader(f)]


def load_verbs(verbs_from_args: List[str], path: str,
               all_verbs: bool = False) -> Tuple[List[int], Dict[int, str], List[dict]]:
    verbs = read_csv_rows(path)
    chosen = verbs if all_verbs else [r for r in verbs if r["key"] in verbs_from_args]
    return [r["id"] for r in chosen], {r["id"]: r["key"] for r in chosen}, verbs


def load_dataset(path: str, small: bool = False) -> List[dict]:
    rows = read_annotations(path, index_key="narration_id")
    return rows[:100] if small else rows


def _embedding(vector) -> Dict[str, np.ndarray]:
    return {"embedding": np.asarray(vector).reshape(1, -1).astype(np.float32)}


def get_nouns_clip_embeddings(nouns: List[dict], path: str,
                              model_name: str = "ViT-B/32") -> Dict[int, Dict[str, np.ndarray]]:
    """noun id -> {"embedding": (1, 512) float32}; written to ``path`` (as
    a dict of (512,) vectors) when it does not exist."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            table = pickle.load(f)
        logger.info("Loaded noun CLIP embeddings from %s", path)
        if hasattr(table, "to_numpy") and hasattr(table, "index"):  # a DataFrame
            return {idx: _embedding(row) for idx, row in zip(table.index, table.to_numpy())}
        return {idx: _embedding(row) for idx, row in table.items()}

    embeddings = _compute_clip_embeddings(nouns, model_name)
    if path:
        with open(path, "wb") as f:
            pickle.dump({k: v["embedding"].reshape(-1) for k, v in embeddings.items()}, f)
    return embeddings


def _compute_clip_embeddings(nouns: List[dict], model_name: str):
    try:
        import torch
        from transformers import CLIPTextModel, CLIPTokenizer

        hf_name = "openai/clip-vit-base-patch32"
        tok = CLIPTokenizer.from_pretrained(hf_name, local_files_only=True)
        mdl = CLIPTextModel.from_pretrained(hf_name, local_files_only=True)
        out = {}
        with torch.no_grad():
            for row in nouns:
                text = f"a photo of a {row['key'].replace(':', ' ')}"
                ids = tok(text, return_tensors="pt", padding=True)
                out[row["id"]] = _embedding(mdl(**ids).pooler_output.numpy())
        logger.info("Computed CLIP noun embeddings via transformers")
        return out
    except Exception as e:
        logger.warning(
            "CLIP model unavailable (%s); using deterministic seeded pseudo-embeddings. "
            "Provide NOUNS_EMBEDDINGS_FILE for real CLIP vectors.", e)
        return {row["id"]: {"embedding": fallback_embedding(row["key"])} for row in nouns}


def fallback_embedding(key) -> np.ndarray:
    """A unit (1, 512) float32 vector drawn from a generator seeded with
    ``zlib.crc32`` of the key: the same in every interpreter."""
    rng = np.random.default_rng(zlib.crc32(str(key).encode("utf-8")))
    v = rng.standard_normal((1, CLIP_DIM)).astype(np.float32)
    return v / np.linalg.norm(v)


def augment_data(rows: List[dict], transforms: Dict[str, Any], balance: bool = True,
                 factor: float = 1.0, seed: Optional[int] = None) -> List[dict]:
    """Every row with ``transformation`` "none", each followed by its
    augmented copies: balanced, a class of n rows against the largest
    class's m gets ``t = (factor * m - n) / n`` copies a row, one with
    probability t for 0 < t <= 1 (``binomial``) and ``round(t)`` above 1,
    each a transformation drawn by ``choice``; unbalanced, one copy a
    transformation."""
    rng = np.random.default_rng(seed)
    counts = collections.Counter(row["verb_class"] for row in rows)
    max_value = factor * max(counts.values())
    t_per_sample = {c: (max_value - n) / n for c, n in counts.items()}
    t_names = list(transforms)

    out = []
    for row in rows:
        row = {**row, "transformation": "none"}
        out.append(row)
        if balance:
            t = t_per_sample[row["verb_class"]]
            draws = 0
            if 0 < t <= 1:
                draws = int(rng.binomial(1, t))
            elif t > 1:
                draws = round(t)
            for _ in range(draws):
                out.append({**row, "transformation": str(rng.choice(t_names))})
        else:
            out.extend({**row, "transformation": name} for name in t_names)
    return out


def extend_data(rows: List[dict], map_ids_verbs: Dict[int, str],
                vectors: Optional[Dict[str, Any]] = None,
                clip_embeddings: Optional[Dict[int, Dict[str, np.ndarray]]] = None) -> List[dict]:
    """Each row with ``noun_embedding`` and ``precs``/``posts`` (+ ``_vec``)."""
    out = []
    for row in rows:
        row = dict(row)
        verb = map_ids_verbs.get(row["verb_class"])
        if clip_embeddings is not None:
            row["noun_embedding"] = clip_embeddings[int(row["noun_class"])]["embedding"]
        if vectors is not None:
            for key in ("precs", "posts", "precs_vec", "posts_vec"):
                row[key] = vectors[verb][key] if verb in vectors else []
        out.append(row)
    return out


def write_attributes(path: str, attributes: List[str]) -> None:
    """``attributes.csv``: an ``attribute`` header and one row each, as
    pandas' ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["attribute"])
        writer.writerows([a] for a in attributes)


def prepare_dataset(cfg) -> Tuple[List[dict], List[dict]]:
    """The whole preparation; returns the processed train and val rows."""
    ek = cfg.EPICKITCHENS
    if ek.SMALL:
        logger.warning("Using small dataset")
        ek.AUGMENT.FACTOR = 1.0
        ek.AUGMENT.ENABLE = True

    ids, map_ids_verbs, _ = load_verbs(ek.VERBS, ek.VERBS_FILE, ek.ALL_VERBS)
    keep = set(ids)
    train_rows = [r for r in load_dataset(ek.ORIGINAL_TRAIN_LIST, ek.SMALL)
                  if r["verb_class"] in keep]
    val_rows = [r for r in load_dataset(ek.ORIGINAL_VAL_LIST, ek.SMALL)
                if r["verb_class"] in keep]
    nouns = read_csv_rows(ek.NOUNS_FILE)

    actions, attributes = parse_pddl(ek.STATE.PDDL_DOMAIN, ek.STATE.PDDL_PROBLEM)
    if not cfg.MODEL.ONLY_ACTION_RECOGNITION:
        missing = set(map_ids_verbs.values()) - {a.name for a in actions}
        assert not missing, f"Some actions are not in the list of verbs: {missing}"
    write_attributes(cfg.MODEL.PDDL_ATTRIBUTES, attributes)

    clip_embeddings = get_nouns_clip_embeddings(nouns, ek.STATE.NOUNS_EMBEDDINGS_FILE,
                                                cfg.MODEL.CLIP_MODEL)
    vectors = {}
    for a in actions:
        precs_vec, posts_vec = a.vectorize(attributes)
        vectors[a.name] = {"precs": [str(p) for p in a.preconditions],
                           "posts": [str(p) for p in a.postconditions],
                           "precs_vec": precs_vec, "posts_vec": posts_vec}

    if ek.AUGMENT.ENABLE:
        train_rows = augment_data(train_rows, get_transforms(), balance=ek.AUGMENT.BALANCE,
                                  factor=ek.AUGMENT.FACTOR, seed=cfg.RNG_SEED)
    train_rows = extend_data(train_rows, map_ids_verbs, vectors, clip_embeddings)
    val_rows = extend_data(val_rows, map_ids_verbs, vectors, clip_embeddings)

    for path, rows in ((ek.PROCESSED_TRAIN_LIST, train_rows), (ek.PROCESSED_VAL_LIST, val_rows)):
        with open(path, "wb") as f:
            pickle.dump(rows, f)
    logger.info("Dataset prepared: %s / %s", ek.PROCESSED_TRAIN_LIST, ek.PROCESSED_VAL_LIST)
    return train_rows, val_rows
