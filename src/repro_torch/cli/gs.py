"""The single GraphStorm command, PyTorch port: one config drives the
run.  The port serves node classification so far:

  # serve the synthetic request stream with seeded random weights
  PYTHONPATH=src python -m repro_torch.cli.gs --serve \\
      --cf examples/configs/nc_mag_device.yaml

  # serve a checkpoint (written by the reference package's save_trainer);
  # without --cf the config persisted next to the model is used
  PYTHONPATH=src python -m repro_torch.cli.gs --serve \\
      --restore-model-path out/nc_mag_device --serve.requests 256

Any config key can be overridden with ``--section.key value``.  The run
uses the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.checkpoint import load_run_config
from repro_torch.config import GSConfig, apply_overrides, load_config_dict
from repro_torch.runner import run_config


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli.gs",
        description="single-command GraphStorm runner (PyTorch port); "
                    "any config key can be overridden with "
                    "--section.key value")
    ap.add_argument("--cf", "--yaml-config-file", dest="cf", default=None,
                    help="YAML/JSON GSConfig file")
    ap.add_argument("--serve", action="store_true",
                    help="serve a batched inference request stream "
                         "(serve.* config keys set the traffic shape)")
    ap.add_argument("--restore-model-path", default=None,
                    help="checkpoint dir; without --cf, the config "
                         "persisted next to the model is used")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    if not args.serve:
        ap.error("only --serve is ported so far")
    if args.cf:
        raw = load_config_dict(args.cf)
    elif args.restore_model_path:
        raw = load_run_config(args.restore_model_path)
    else:
        ap.error("pass --cf <config>, or --restore-model-path <dir> to "
                 "reuse the config persisted with a checkpoint")
    if args.restore_model_path:
        raw.setdefault("output", {})["restore_model_path"] = \
            args.restore_model_path
    if overrides:
        raw = apply_overrides(raw, overrides)
    result = run_config(GSConfig.from_dict(raw), device=args.device)
    print(json.dumps(result, indent=2, default=str))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
