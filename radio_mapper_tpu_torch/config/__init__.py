"""Typed configuration system.

Port of ``radio_mapper_tpu/config``. Schema and behaviors mirror the
reference's `config_manager.py` / `config.yaml` (YAML + deep-merge over
defaults, ``${VAR:-default}`` env expansion with numeric coercion,
assert-style validation, dot-path access) as typed dataclasses. The field
names are the on-disk YAML format, the ``tpu:`` section included, so a
file written by either package loads in the other to an equal dict.
"""

from radio_mapper_tpu_torch.config.schema import (
    BuoyConfig,
    Config,
    EmergencyConfig,
    GpsConfig,
    LoggingConfig,
    SdrConfig,
    ServerConfig,
    SignalDetectionConfig,
    StorageConfig,
    TdoaConfig,
    TimingConfig,
    TpuConfig,
    WebConfig,
)
from radio_mapper_tpu_torch.config.loader import (
    config_to_dict,
    deep_merge,
    expand_env,
    generate_example_yaml,
    get_config,
    load_config,
    reset_config,
)

__all__ = [
    "BuoyConfig",
    "Config",
    "EmergencyConfig",
    "GpsConfig",
    "LoggingConfig",
    "SdrConfig",
    "ServerConfig",
    "SignalDetectionConfig",
    "StorageConfig",
    "TdoaConfig",
    "TimingConfig",
    "TpuConfig",
    "WebConfig",
    "config_to_dict",
    "deep_merge",
    "expand_env",
    "generate_example_yaml",
    "get_config",
    "load_config",
    "reset_config",
]
