from .config import DotDict, load_config, merge_config
from .device import resolve_device
from .misc import default, get_num_params
from .naming import get_model_name
from .prng import get_seed, split_like
from .system import (find_files, get_file_size, get_memory, get_size, get_system,
                     is_interactive)
from .timing import simple_timer, timer

__all__ = ["get_seed", "split_like", "timer", "simple_timer", "load_config",
           "merge_config", "DotDict", "get_model_name", "default", "get_num_params",
           "is_interactive", "get_size", "get_file_size", "find_files", "get_memory",
           "get_system", "resolve_device"]
