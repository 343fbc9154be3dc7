from repro_torch.checkpoint.io import (flatten_params, load_flat,
                                       load_run_config, load_trainer,
                                       params_from_flat)

__all__ = ["flatten_params", "load_flat", "load_run_config",
           "load_trainer", "params_from_flat"]
