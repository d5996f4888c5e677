"""Configuration: Shadow-compatible YAML schema + CLI overrides."""

from shadow_tpu_torch.config.schema import (  # noqa: F401
    ConfigOptions,
    GeneralOptions,
    ExperimentalOptions,
    HostOptions,
    ProcessOptions,
    load_config,
    parse_config,
)
