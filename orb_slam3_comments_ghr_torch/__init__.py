"""PyTorch + CUDA port of the SLAM engine: monocular, stereo and RGB-D, each
with or without an IMU (`system.SLAM`).

Module paths and function names mirror `orb_slam3_comments_ghr_tpu`, which
stays the reference the port is tested against. This package imports torch
and numpy only, never jax and never the JAX package, so it runs on a GPU
machine without JAX.

Tensors run where they lie: every function works on the device of its
inputs. On a CUDA tensor the window match launches its hand-written Hopper
kernel (`ops/window_match.py`); on a CPU tensor it runs the plain PyTorch
version.
"""

import torch

# Everything is float32. TF32 keeps ~3 decimal digits, which biases the pose
# LM's normal equations and the pyramid resampling the same way bf16 did on
# the TPU (see the JAX package's utils/precision.py), so both switches stay
# off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
