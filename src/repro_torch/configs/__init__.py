"""Architecture configs: ``get_config("bitnet-3b")`` and
``get_config("bitnet-3b-reduced")``."""

from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      register, resolve_config,
                                      resolve_decode_flags)
