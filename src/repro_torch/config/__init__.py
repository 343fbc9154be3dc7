from repro_torch.config.gsconfig import (ConfigError, DATASET_TARGETS,
                                         GnnConfig, GSConfig,
                                         HyperparamConfig, InputConfig,
                                         NodeClassificationConfig,
                                         OutputConfig, ServeConfig,
                                         apply_overrides, load_config_dict)

__all__ = ["ConfigError", "DATASET_TARGETS", "GSConfig", "GnnConfig",
           "HyperparamConfig", "InputConfig", "NodeClassificationConfig",
           "OutputConfig", "ServeConfig", "apply_overrides",
           "load_config_dict"]
