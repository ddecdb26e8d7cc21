from sgam_neurips22_tpu_torch.core.config import (
    ConfigDict,
    apply_dotlist,
    load_configs,
    load_yaml,
    merge,
    save_yaml,
    wrap,
)
from sgam_neurips22_tpu_torch.core.registry import (
    get,
    instantiate_from_config,
    known_targets,
    register,
)

__all__ = [
    "ConfigDict",
    "apply_dotlist",
    "load_configs",
    "load_yaml",
    "merge",
    "save_yaml",
    "wrap",
    "get",
    "instantiate_from_config",
    "known_targets",
    "register",
]
