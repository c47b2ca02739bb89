"""PyTorch/CUDA port of voxelengine_tpu.

Mirrors the JAX package's layout and function names; imports torch and
never JAX.  Plain tensor code is torch; the traversal kernel is hand-written
CUDA for Hopper (``csrc/``), built at first use (``kernels/``).
"""

from voxelengine_tpu_torch.config import (  # noqa: F401
    FLT_EPS_DDA,
    MAX_STEPS,
    DebugView,
    Environment,
    Projection,
    RenderConfig,
)
