from .builders import MODEL_REGISTRY, AudioSlowFast, build_model

__all__ = ["MODEL_REGISTRY", "AudioSlowFast", "build_model"]
