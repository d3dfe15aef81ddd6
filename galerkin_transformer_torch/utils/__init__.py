from .config import load_config
from .device import resolve_device
from .misc import default

__all__ = ["load_config", "resolve_device", "default"]
