"""Config, builders, the JAX parameter bridge, EMA, checkpoints, logging,
the metric writers, profiling and the keras-weights InceptionV3; exports
what npcd_tpu.utils exports."""
from .config import load_config, print_config, pointnerf_default_options
from .util import chunks, split_num, to_numpy, count_parameters, psnr
from . import logging
