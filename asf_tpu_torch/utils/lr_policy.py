"""Learning-rate policies: cosine, steps with relative LRs, linear warm-up.

The port's copy of ``asf_tpu/utils/lr_policy.py:13-50`` (plain floats, no
framework). The train step takes the LR as an argument and writes it into
every optimizer param group (``engine/optimizer.py:set_lr``).
"""

import math


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_func_cosine(cfg, cur_epoch: float) -> float:
    assert cfg.SOLVER.COSINE_END_LR < cfg.SOLVER.BASE_LR
    return (
        cfg.SOLVER.COSINE_END_LR
        + (cfg.SOLVER.BASE_LR - cfg.SOLVER.COSINE_END_LR)
        * (math.cos(math.pi * cur_epoch / cfg.SOLVER.MAX_EPOCH) + 1.0)
        * 0.5
    )


def lr_func_steps_with_relative_lrs(cfg, cur_epoch: float) -> float:
    ind = get_step_index(cfg, cur_epoch)
    return cfg.SOLVER.LRS[ind] * cfg.SOLVER.BASE_LR


def get_step_index(cfg, cur_epoch: float) -> int:
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def get_lr_func(lr_policy: str):
    policy = "lr_func_" + lr_policy
    if policy not in globals():
        raise NotImplementedError(f"Unknown LR policy: {lr_policy}")
    return globals()[policy]
