"""Architecture configs: ``get_config("granite-moe-1b-a400m")`` and
``get_config("granite-moe-1b-a400m-reduced")``, one module an
architecture."""

from repro_torch.configs.base import (ModelConfig, all_configs,  # noqa: F401
                                      get_config, register, resolve_config,
                                      resolve_decode_flags)
