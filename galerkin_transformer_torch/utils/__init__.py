from .config import load_config, merge_config
from .device import resolve_device
from .misc import default
from .naming import get_model_name

__all__ = ["load_config", "merge_config", "resolve_device", "default", "get_model_name"]
