"""hydrolim_tpu_torch — the PyTorch + CUDA port of ``hydrolim_tpu``.

The module tree and function names mirror the JAX package, so each
counterpart is found at the same path.  The package imports ``torch`` and
never ``jax``.  The JAX package's four TPU kernels run as three
hand-written CUDA kernels for sm_90a, built with ``nvcc`` at first use:
B1 (``ops/stepper_kernel.py``), B2 (``ops/pde_kernel.py``) and B3/B4, one
kernel for both TPU layouts (``ops/exclusion_kernel.py``).  On CPU tensors
each wrapper runs its plain PyTorch version instead.

Float32 products run in full f32 where the reference used
``Precision.HIGHEST``: TF32 is switched off for matmuls and convolutions.

The facades of the JAX package are exported here as there: ``IMEXPDE``
and ``ParticleSystem``.
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
from hydrolim_tpu_torch.particles.system import ParticleSystem  # noqa: E402,F401
from hydrolim_tpu_torch.pde.system import IMEXPDE  # noqa: E402,F401
