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
from voxelengine_tpu_torch.core.bitgrid import BitGrid  # noqa: F401
from voxelengine_tpu_torch.core.brickmap import BrickMap, build_brickmap  # noqa: F401
from voxelengine_tpu_torch.engine.raytracer import RayTraceResults, VoxelRaytracer3D  # noqa: F401
