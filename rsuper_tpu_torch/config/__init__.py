from .config import DEFAULT_CONFIGS, TrainConfig, load_config

__all__ = ["TrainConfig", "load_config", "DEFAULT_CONFIGS"]
