"""Main-path entry (counterpart of ``__graft_entry__.entry``).

``entry()`` builds the shipped serving graph for the flagship model,
BiSeNet-R18 real-time (``cityscapes.bisenet.R18.speed``) at 1024x2048, as
the int8-through graph with seeded random weights, calibrated on two random
256x512 images from ``np.random.default_rng(0)`` as the JAX entry is.  It
returns ``infer, (pkg, xs)``; ``infer(pkg, xs)`` gives (1, H/8, W/8) int32
labels.

TF32 is switched off for cuDNN convolutions and matmuls: calibration runs
the float graph in float32, and TF32 would round its convolutions to ~10
mantissa bits on the card.
"""

import numpy as np
import torch

from .deploy.int8_serve import build_int8_serving_for_experiment
from .experiments.registry import build_model, get_experiment
from .models import init_weights

EXPERIMENT = "cityscapes.bisenet.R18.speed"


def entry(device="cuda", image_hw=(1024, 2048), seed: int = 0):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_experiment(EXPERIMENT)
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(seed)).to(device)
    infer, pkg, prepare = build_int8_serving_for_experiment(cfg, model)
    xs = prepare(np.zeros((1, *image_hw, 3), np.uint8))
    return infer, (pkg, xs)
