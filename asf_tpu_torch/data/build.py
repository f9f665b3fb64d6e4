"""Dataset registry: copy of ``asf_tpu/data/build.py`` (a plain dict, looked
up without regard to case)."""

DATASET_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls

    return deco


def build_dataset(dataset_name, cfg, split):
    for key, cls in DATASET_REGISTRY.items():
        if key.lower() == dataset_name.lower():
            return cls(cfg, split)
    raise KeyError(
        f"Dataset '{dataset_name}' not registered; have {sorted(DATASET_REGISTRY)}"
    )
