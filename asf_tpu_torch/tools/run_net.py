"""Train, then test, from a config file and command-line overrides.

    python -m asf_tpu_torch.tools.run_net --cfg config.yaml [KEY VALUE ...]

Counterpart of ``asf_tpu/tools/run_net.py``: ``train(cfg)`` when
``TRAIN.ENABLE``, then ``test(cfg)`` when ``TEST.ENABLE``, both on the
current CUDA device (``--device cpu`` runs them on the CPU). The config file is YAML (the subset of
``config/yaml_lite.py``, no PyYAML) or JSON.
"""

import functools

from ..engine import test, train
from ..utils.parser import load_config, parse_args


def launch_job(cfg, init_method=None, func=None):
    """Runs ``func(cfg)`` in this process. ``NUM_SHARDS > 1`` raises: the
    process group and the gradient all-reduce are not ported yet."""
    if cfg.NUM_SHARDS > 1:
        raise NotImplementedError(
            f"NUM_SHARDS = {cfg.NUM_SHARDS} (init method {init_method}): "
            "run_net runs one process on one device")
    return func(cfg)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args)

    if cfg.TRAIN.ENABLE:
        launch_job(cfg, args.init_method, functools.partial(train, device=args.device))

    if cfg.TEST.ENABLE:
        launch_job(cfg, args.init_method, functools.partial(test, device=args.device))


if __name__ == "__main__":
    main()
