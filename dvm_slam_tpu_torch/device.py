"""Precision policy of the port.

The reference forces true f32 matrix products
(`dvm_slam_tpu/__init__.py`: `jax_default_matmul_precision = "highest"`):
Gauss-Newton normal equations diverge and Hamming distances stop being exact
integers at reduced precision. On the card, PyTorch's f32 matmul already runs
in full f32 by default but cuDNN convolutions use TF32, so both switches are
set here, once, when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
