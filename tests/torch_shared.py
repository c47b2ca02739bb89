"""What several of the port's test files compute alike, computed once a
test run: the first file to ask makes it, under a file lock, and leaves it
in the run's temporary directory, which every pytest-xdist worker of the
run shares; the others load it.  Not a test module."""

import fcntl
import os

import torch


def shared(tmp_path_factory, key: str, make):
    """``make()``'s value (tensors, or objects of them that ``torch.save``
    takes), made once for the run under ``key``."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory, above each worker's own
    path = root / f"shared_{key}.pt"
    with open(root / f"shared_{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return torch.load(path, weights_only=False)
        value = make()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(value, tmp)
        os.replace(tmp, path)
        return value


def terrain_128x64x128_f32_o3(tmp_path_factory):
    """The port's compact 128x64x128 terrain at factor 32, 3 octaves, built
    on the CPU (``tests/test_torch_brickmap.py`` and
    ``tests/test_torch_macro.py`` hold it against JAX's)."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact

    return shared(tmp_path_factory, "terrain_128x64x128_f32_o3",
                  lambda: build_brickmap_terrain_compact((128, 64, 128), 32, octaves=3, device="cpu"))
