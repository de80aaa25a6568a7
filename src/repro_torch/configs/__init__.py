from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import get_config, reduced_config  # noqa: F401
