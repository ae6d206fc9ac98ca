"""hydrolim_tpu_torch — the PyTorch + CUDA port of ``hydrolim_tpu``.

The module tree and function names mirror the JAX package, so each
counterpart is found at the same path.  The package imports ``torch`` and
never ``jax``.  Kernels B1 (``ops/stepper_kernel.py``) and B2
(``ops/pde_kernel.py``) are hand-written CUDA for sm_90a, built with
``nvcc`` at first use; on CPU tensors each wrapper runs its plain PyTorch
version instead.

Float32 products run in full f32 where the reference used
``Precision.HIGHEST``: TF32 is switched off for matmuls and convolutions.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from hydrolim_tpu_torch.core.config import (  # noqa: E402,F401
    ParticleConfig,
    ParticleParams,
    PDEConfig,
    PDEParams,
)
