"""Training entry point (python -m fv3net_tpu_torch.fit.train, the
fv3fit/train.py:104 CLI equivalent; the JAX package's ``fit/train.py``):
training config YAML + data config YAML + output path, with dotted-key
CLI overrides (get_arg_updated_config_dict, train.py:112).

    python -m fv3net_tpu_torch.fit.train training.yml data.yml out \
        [key=value ...] [--device DEVICE]

The model trains on the CUDA device unless --device names another
(``--device cpu``); without a CUDA device the default raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import yaml

from . import _shared
from ._shared import (
    TrainingConfig,
    dump,
    get_hyperparameter_class,
    get_training_function,
)
from ..data import open_batches_from_config

logger = logging.getLogger(__name__)


def get_arg_updated_config_dict(args, config_dict):
    """Apply --key value CLI overrides to nested dict keys (dots)."""
    for item in args:
        key, value = item.split("=", 1)
        parts = key.lstrip("-").split(".")
        d = config_dict
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        d[parts[-1]] = value
    return config_dict


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("training_config")
    parser.add_argument("training_data_config")
    parser.add_argument("output_path")
    parser.add_argument("overrides", nargs="*")
    parser.add_argument(
        "--device", default=None,
        help="torch device of the training (default: the CUDA device)",
    )
    args = parser.parse_args(argv)
    device = _shared.train_device(args.device, "fit.train")

    with open(args.training_config) as f:
        cfg_dict = yaml.safe_load(f)
    cfg_dict = get_arg_updated_config_dict(args.overrides, cfg_dict)
    config = TrainingConfig.from_dict(cfg_dict)

    with open(args.training_data_config) as f:
        data_cfg = yaml.safe_load(f)
    batches = open_batches_from_config(data_cfg)

    from ..utils.artifacts import StepMetadata

    StepMetadata(
        job_type="train",
        url=args.output_path,
        dependencies={"training_data": args.training_data_config},
        args=list(argv) if argv is not None else sys.argv[1:],
    ).print_json()

    train = get_training_function(config.model_type)
    hp_cls = get_hyperparameter_class(config.model_type)
    hp = hp_cls(**config.hyperparameters) if hp_cls else None
    model = train(
        hp,
        batches,
        input_variables=config.input_variables,
        output_variables=config.output_variables,
        device=device,
    )
    dump(model, args.output_path)
    logger.info("model written to %s", args.output_path)
    print(json.dumps({"output_path": args.output_path}))


if __name__ == "__main__":
    main()
