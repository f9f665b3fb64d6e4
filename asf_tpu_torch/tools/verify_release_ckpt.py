"""One-command check of a released reference checkpoint.

    python -m asf_tpu_torch.tools.verify_release_ckpt SLOWFAST_EPIC.pyth
    python -m asf_tpu_torch.tools.verify_release_ckpt https://.../SLOWFAST_EPIC.pyth?dl=1
    python -m asf_tpu_torch.tools.verify_release_ckpt ckpt.pyth --model slow --dataset vgg
    python -m asf_tpu_torch.tools.verify_release_ckpt --self-test [--device cpu]

Counterpart of ``scripts/verify_release_ckpt.py`` (``build_cfg`` :50,
``fixture_wav`` :79, ``fetch`` :98, ``verify`` :128, ``self_test`` :171):
a local path or a URL (downloaded once into the temporary directory) ->
the port's own ``.pyth`` load (``checkpoint/manager.py:load_checkpoint``,
a ``module.`` prefix cut with ``tools/fix_weights.py``, every leaf of the
release model's config taken by name and shape through
``checkpoint/pyth_names.py:load_into``) -> the port's ``predict`` run twice
on a deterministic fixture wav -> a JSON snapshot of each head's scores
(argmax, top 5, the first 8 values, a hash) -> the argmax and the scores
equal across the two runs. ``--self-test`` needs no download: it seeds the
tiny model of the tests, saves it as a reference ``.pyth`` and runs the
same check, then holds the snapshot to the saved model's own forward on
the same input.

Exit codes: 0 verified, 2 download or load failure, 3 instability, or
leaves the checkpoint does not give. Runs on the current CUDA device
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

# Release-file geometry (the reference's configs/EPIC-KITCHENS/*.yaml and
# configs/VGG-Sound/*.yaml): EPIC heads are (97 verbs, 300 nouns);
# VGG-Sound is a single 309-class head.
NUM_CLASSES = {"epic": [97, 300], "vgg": [309]}


def build_cfg(model: str, dataset: str, tiny: bool = False):
    """The release model's config: SlowFast, Slow-only or Fast-only R50 with
    the dataset's heads, float32 trunk and front end (the released weights
    were trained in float32; this check is about loading them faithfully)."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "AudioSlowFast" if model == "slowfast" else "ResNet"
    cfg.MODEL.ARCH = model
    cfg.MODEL.NUM_CLASSES = list(NUM_CLASSES[dataset])
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True  # the released heads: no state head
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3, 3], [4, 4], [6, 6], [3, 3]]
    cfg.RESNET.FREQUENCY_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.FREQUENCY_DILATIONS = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.GPU.COMPUTE_DTYPE = "float32"
    cfg.GPU.DSP_PRECISION = "HIGHEST"
    if tiny:  # the self-test's geometry (tests/fixtures.py tiny_cfg)
        cfg.AUDIO_DATA.SAMPLING_RATE = 8000
        cfg.AUDIO_DATA.N_FFT = 256
        cfg.AUDIO_DATA.CLIP_SECS = 0.32
        cfg.AUDIO_DATA.NUM_FRAMES = 64
        cfg.AUDIO_DATA.NUM_FREQUENCIES = 32
        cfg.SLOWFAST.ALPHA = 4
        cfg.MODEL.NUM_CLASSES = [6, 8]
        cfg.RESNET.DEPTH = 26
        cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    return cfg


def fixture_wav(cfg, path: str) -> str:
    """A deterministic signal of two clips' length: two tones and seeded
    noise, int16, so that the snapshot compares across machines."""
    from scipy.io import wavfile

    sr = cfg.AUDIO_DATA.SAMPLING_RATE
    n = int(sr * cfg.AUDIO_DATA.CLIP_SECS * 2)
    t = np.arange(n, dtype=np.float64) / sr
    rng = np.random.default_rng(20260819)
    wave = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 1873.0 * t)
            + 0.05 * rng.standard_normal(n))
    wavfile.write(path, sr, (wave * 20000).astype(np.int16))
    return path


def fetch(url_or_path: str) -> str:
    """A local path as it is (exit 2 when absent), or a URL downloaded once
    into the temporary directory (exit 2 when the download fails)."""
    if not url_or_path.startswith(("http://", "https://")):
        if not os.path.exists(url_or_path):
            print(f"checkpoint not found: {url_or_path}", file=sys.stderr)
            raise SystemExit(2)
        return url_or_path
    import urllib.request

    dst = os.path.join(tempfile.gettempdir(), "release_"
                       + hashlib.sha1(url_or_path.encode()).hexdigest()[:12] + ".pyth")
    if os.path.exists(dst):
        print(f"using cached download {dst}")
        return dst
    print(f"downloading {url_or_path} -> {dst}")
    try:
        # Dropbox links need ?dl=1 to serve the file instead of the page.
        urllib.request.urlretrieve(url_or_path.replace("?dl=0", "?dl=1"), dst)
    except Exception as e:  # noqa: BLE001 - an actionable message and a clean exit
        print(f"download failed ({type(e).__name__}: {e}); pass a local path instead",
              file=sys.stderr)
        raise SystemExit(2)
    return dst


def load_release(ckpt_path: str, cfg, out_dir: str) -> str:
    """The checkpoint as the port's ``.pyth`` of ``cfg``'s model: its
    ``model_state`` (a ``module.`` prefix cut), every leaf of the model taken
    by name and shape, written to ``out_dir/release.pyth``; returns that
    path. Exit 2 when it does not load, 3 when it leaves a leaf out."""
    from ..checkpoint.manager import load_checkpoint
    from ..checkpoint.pyth_names import load_into
    from ..models import build_model
    from .fix_weights import fix_state_keys

    try:
        ckpt = load_checkpoint(ckpt_path)
        state = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else None
        if not isinstance(state, dict):
            raise ValueError(f"no model_state in {type(ckpt).__name__}")
    except Exception as e:  # noqa: BLE001 - an unreadable file is exit 2
        print(f"load failed ({type(e).__name__}: {e})", file=sys.stderr)
        raise SystemExit(2)
    state = fix_state_keys(state, strip_prefix="module.")
    skipped = load_into(build_model(cfg.clone(), "cpu"), state)
    if skipped:
        print(f"FAIL: {len(skipped)} leaves not given by the checkpoint, e.g. {skipped[:3]}",
              file=sys.stderr)
        raise SystemExit(3)
    path = os.path.join(out_dir, "release.pyth")
    torch.save({"model_state": state, "epoch": ckpt.get("epoch", 0)}, path)
    return path


def verify(ckpt_path: str, cfg, wav: str, out_dir: str, device=None) -> dict:
    """Load, then ``predict`` twice on ``wav``; returns the snapshot (exit 3
    when the runs differ)."""
    from . import predict

    cfg = cfg.clone()
    cfg.TEST.CHECKPOINT_FILE_PATH = load_release(ckpt_path, cfg, out_dir)
    cfg.OUTPUT_DIR = out_dir
    cfg_yaml = os.path.join(out_dir, "verify_cfg.yaml")
    with open(cfg_yaml, "w") as f:
        f.write(cfg.dump())
    argv = [wav, "--cfg", cfg_yaml] + ([] if device is None else ["--device", str(device)])
    runs = [[np.asarray(p, np.float32) for p in predict.main(argv)] for _ in range(2)]

    names = ["verb", "noun"] if len(runs[0]) > 1 else ["class"]
    snapshot = {"checkpoint": os.path.basename(ckpt_path), "heads": {}}
    stable = True
    for name, a, b in zip(names, runs[0], runs[1]):
        sa = a.reshape(-1, a.shape[-1]).sum(0)
        sb = b.reshape(-1, b.shape[-1]).sum(0)
        stable &= int(sa.argmax()) == int(sb.argmax()) and np.array_equal(a, b)
        snapshot["heads"][name] = {
            "shape": list(a.shape),
            "argmax": int(sa.argmax()),
            "top5": [int(i) for i in np.argsort(sa)[::-1][:5]],
            "logits_head": [round(float(x), 5) for x in sa[:8]],
            "sha256": hashlib.sha256(np.round(sa, 4).astype(np.float32).tobytes()).hexdigest()[:16],
        }
    snapshot["stable_across_runs"] = bool(stable)
    print(json.dumps(snapshot, indent=2))
    if not stable:
        print("FAIL: predictions differ across two identical runs", file=sys.stderr)
        raise SystemExit(3)
    print(f"OK: {os.path.basename(ckpt_path)} loads and predicts stably")
    return snapshot


def self_test(out_dir: str, device=None) -> dict:
    """The whole check with no download: the tiny model's weights from seed 7
    (``predict`` would draw its own from ``RNG_SEED``) saved as a reference
    ``.pyth``, ``verify``, then the snapshot held to that model's own eval
    forward on the fixture's pathways (2e-4), so the run must have used the
    saved weights."""
    from ..models import build_model
    from ..utils.torch_setup import disable_tf32, resolve_device
    from .predict import load_audio

    dev = resolve_device(device)
    disable_tf32()
    cfg = build_cfg("slowfast", "epic", tiny=True)
    cfg.RNG_SEED = 0
    wav = fixture_wav(cfg, os.path.join(out_dir, "fixture.wav"))
    model = build_model(cfg.clone(), dev, torch.Generator().manual_seed(7)).eval()
    ckpt = os.path.join(out_dir, "selftest.pyth")
    torch.save({"model_state": {k: v.cpu() for k, v in model.state_dict().items()},
                "epoch": 3}, ckpt)

    snap = verify(ckpt, cfg, wav, out_dir, dev)

    with torch.inference_mode():
        want = model(load_audio(cfg, wav, dev))
    for name, p in zip(["verb", "noun"], want):
        sa = p.float().cpu().numpy().reshape(-1, p.shape[-1]).sum(0)
        np.testing.assert_allclose(snap["heads"][name]["logits_head"], np.round(sa[:8], 5),
                                   atol=2e-4)
    print("self-test OK: the .pyth round trip drives predict")
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", help=".pyth URL or local path")
    ap.add_argument("--model", choices=["slowfast", "slow", "fast"], default="slowfast")
    ap.add_argument("--dataset", choices=["epic", "vgg"], default="epic")
    ap.add_argument("--wav", default=None, help="override the fixture wav")
    ap.add_argument("--out", default=None, help="output dir (a temporary one by default)")
    ap.add_argument("--device", default=None,
                    help="Device to run on: the current CUDA device unless 'cpu'")
    ap.add_argument("--self-test", action="store_true",
                    help="verify the flow against a locally built .pyth")
    args = ap.parse_args(argv)

    out_dir = args.out or tempfile.mkdtemp(prefix="verify_ckpt_")
    os.makedirs(out_dir, exist_ok=True)
    if args.self_test:
        self_test(out_dir, args.device)
        return 0
    if not args.checkpoint:
        ap.error("checkpoint (URL or path) required unless --self-test")
    cfg = build_cfg(args.model, args.dataset)
    wav = args.wav or fixture_wav(cfg, os.path.join(out_dir, "fixture.wav"))
    verify(fetch(args.checkpoint), cfg, wav, out_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
