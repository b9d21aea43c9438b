"""CLI entry point: ``python -m tpu3d_torch [config.yaml]``.

The argv contract of ``python -m tpu3d`` and of the reference binary
(src/main.cpp:80-94): one optional positional argument, the config path,
defaulting to ``config/pipeline_config.yaml``; returns 0 once the pipeline
has run. ``use_gpu: true`` (the default) runs on the card, ``false`` on
the CPU.
"""

import sys

from tpu3d_torch.config import load_config
from tpu3d_torch.pipeline.pipeline import Pipeline


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print("=== tpu3d_torch — bin-picking pipeline on PyTorch/CUDA ===\n")
    config_path = argv[0] if argv else "config/pipeline_config.yaml"
    config = load_config(config_path)
    pipeline = Pipeline(config)
    pipeline.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
