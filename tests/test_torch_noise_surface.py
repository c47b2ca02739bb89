"""The port's noise library beyond the worldgen subset, against the JAX
package's ``ops/noise.py``: every helper, basis noise, repeater and
turbulence on 3072 random points (small, negative and large coordinates),
bit for bit; and each reference quirk the two keep on purpose as its own
case.

The JAX side runs once, in a subprocess whose XLA:CPU neither contracts
FMAs nor runs the algebraic simplifier (``tests/test_torch_render.py``
module doc), so both sides round every float op on its own.  Tolerance:
bit-equal (``assert_array_equal``) everywhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.ops import noise as TN

ROOT = Path(__file__).resolve().parent.parent
SEED = -123457  # a negative int32 seed exercises the int32 wrap
N_POINTS = 1024  # per coordinate range


def _inputs():
    rng = np.random.default_rng(0x5EED)
    small = rng.uniform(-4.0, 4.0, (N_POINTS, 3))
    medium = rng.uniform(-600.0, 600.0, (N_POINTS, 3))
    large = rng.uniform(-2.0e5, 2.0e5, (N_POINTS, 3))
    pos = np.concatenate([small, medium, large]).astype(np.float32)
    ints = rng.integers(-(2**31), 2**31, (3 * N_POINTS,), dtype=np.int64).astype(np.int32)
    cells = rng.integers(-5000, 5000, (3, 3 * N_POINTS)).astype(np.int32)
    frac = rng.random((5, 3 * N_POINTS)).astype(np.float32) * 2.0 - 0.5
    return dict(pos=pos, ints=ints, cells=cells, frac=frac)


def _cases(N, A):
    """name -> thunk computing the case with noise module ``N`` on the
    inputs converted by ``A`` (numpy -> the module's array type)."""
    x = _inputs()
    pos, ints, cells, frac = A(x["pos"]), A(x["ints"]), A(x["cells"]), A(x["frac"])
    p01 = A(x["pos"] * np.float32(0.01))  # for the repeaters: octaves stay inside int32 cells
    B, S = N.Basis, N.Shape
    cases = {
        "saturate": lambda: N.saturate(frac[0]),
        "random_int_range": lambda: N.random_int_range(-7, 11, ints),
        "random_grid": lambda: N.random_grid(cells[0], cells[1], cells[2], 17.0),
        "random_grid_float_cells": lambda: N.random_grid(pos[:, 0], pos[:, 1], pos[:, 2]),
        "vector_noise": lambda: N.vector_noise(pos[:, 0], pos[:, 1], pos[:, 2]),
        "map_to_signed": lambda: N.map_to_signed(frac[0]),
        "map_to_unsigned": lambda: N.map_to_unsigned(frac[0]),
        "cubic": lambda: N.cubic(frac[0], frac[1], frac[2], frac[3], frac[4]),
        "tricubic": lambda: N.tricubic(cells[0], cells[1], cells[2], frac[0], frac[1], frac[2]),
        "simplex_noise": lambda: N.simplex_noise(pos, 0.37, SEED),
        "checker": lambda: N.checker(pos, 0.75, SEED),
        "discrete_noise": lambda: N.discrete_noise(pos, 0.5, SEED),
        "linear_value": lambda: N.linear_value(pos, 3.0, SEED),
        "faded_value": lambda: N.faded_value(pos, 1.0, SEED),
        "cubic_value": lambda: N.cubic_value(pos, 0.8, SEED),
        "worley_noise": lambda: N.worley_noise(pos, 1.0, SEED, 0.5, 2, 4, 0.9),
        "worley_noise_zero_size": lambda: N.worley_noise(pos, 1.0, SEED, 0.0, 2, 4, 0.9),
        "spots_step": lambda: N.spots(pos, 1.0, SEED, 0.3, 0, 3, 1.0, S.STEP),
        "spots_linear": lambda: N.spots(pos, 1.0, SEED, 0.3, 1, 3, 1.0, S.LINEAR),
        "spots_quadratic": lambda: N.spots(pos, 1.0, SEED, 0.3, 0, 2, 0.7, S.QUADRATIC),
        "repeater_perlin_bounded": lambda: N.repeater_perlin_bounded(p01, 1.0, SEED, 5, 2.0, 0.5, 0.3),
        "repeater_perlin_abs": lambda: N.repeater_perlin_abs(p01, 1.0, SEED, 4, 2.0, 0.5),
        "repeater_simplex": lambda: N.repeater_simplex(p01, 1.0, SEED, 4, 2.0, 0.5),
        "repeater_simplex_abs": lambda: N.repeater_simplex_abs(p01, 1.0, SEED, 4, 2.0, 0.5),
        "repeater_simplex_bounded": lambda: N.repeater_simplex_bounded(p01, 1.0, SEED, 4, 2.0, 0.5, 0.2),
        "fractal_simplex": lambda: N.fractal_simplex(p01, 1.0, SEED, 0.05, 8, 2.0, 0.5),
        "repeater_turbulence": lambda: N.repeater_turbulence(p01, 0.5, 1.0, SEED, 2.0, 2, B.PERLIN, B.SIMPLEX),
    }
    for b in B:
        cases[f"repeater_{b.name}"] = (lambda b=b: N.repeater(p01, 1.0, SEED, 2, 2.0, 0.5, b))
    for bi, bo in ((B.PERLIN, B.CHECKER), (B.SIMPLEX, B.SIMPLEX), (B.WORLEY, B.WORLEY), (B.CUBICVALUE, B.FADEDVALUE),
                   (B.CHECKER, B.LINEARVALUE), (B.LINEARVALUE, B.PERLIN), (B.FADEDVALUE, B.CUBICVALUE)):
        cases[f"turbulence_{bi.name}_{bo.name}"] = (
            lambda bi=bi, bo=bo: N.turbulence(p01, 0.5, 0.25, SEED, 3.0, bi, bo))
    # the quirks, each its own case
    cases["quirk_clamp_ignores_bounds"] = lambda: N.clamp(frac[0] * 4.0, -5.0, 5.0)
    cases["quirk_grad_table"] = lambda: N.grad(A(np.arange(16, dtype=np.int32)), A(np.full(16, 2.0, np.float32)),
                                               A(np.full(16, 3.0, np.float32)), A(np.full(16, 5.0, np.float32)))
    cases["quirk_turbulence_unseeded_in_basis"] = lambda: N.turbulence(p01, 0.5, 0.25, SEED, 3.0, B.DISCRETE,
                                                                       B.PERLIN)
    cases["quirk_turbulence_spots_out_is_zero"] = lambda: N.turbulence(p01, 0.5, 0.25, SEED, 3.0, B.PERLIN,
                                                                       B.SPOTS)
    return cases


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax.numpy as jnp

    from voxelengine_tpu.ops import noise as JN

    return {k: np.asarray(fn()) for k, fn in _cases(JN, jnp.asarray).items()}


def _torch_cases():
    return _cases(TN, torch.from_numpy)


CASE_NAMES = sorted(_torch_cases())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port side on one CPU thread (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "noise_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port():
    return {k: fn() for k, fn in _torch_cases().items()}


@pytest.mark.parametrize("name", CASE_NAMES)
def test_noise_function_bit_equal(ref, port, name):
    got = port[name].numpy()
    want = ref[name]
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_quirk_clamp_ignores_bounds():
    v = torch.tensor([-3.0, 0.5, 3.0])
    assert TN.clamp(v, -5.0, 5.0).tolist() == [0.0, 0.5, 1.0]


def test_quirk_grad_aliases():
    """Hash entries 0xC-0xF alias 0, 9, 1 and 11 (``cuda_noise.cuh:173-195``)."""
    x, y, z = torch.tensor(2.0), torch.tensor(3.0), torch.tensor(5.0)
    for h, alias in ((12, 0), (13, 9), (14, 1), (15, 11)):
        assert TN.grad(torch.tensor(h), x, y, z) == TN.grad(torch.tensor(alias), x, y, z)


def test_quirk_repeater_perlin_abs_reuses_one_seed():
    pos = torch.from_numpy(_inputs()["pos"][:256] * np.float32(0.01))
    want = torch.zeros(256)
    for sc, amp in ((1.0, 1.0), (2.0, 0.5), (4.0, 0.25)):
        want = want + torch.abs(TN.perlin_noise(pos * sc, 1.0, SEED)) * amp
    assert torch.equal(TN.repeater_perlin_abs(pos, 1.0, SEED, 3, 2.0, 0.5), TN.map_to_signed(want))


def test_quirk_turbulence_switch_defaults():
    """An input basis without seeds leaves ``pos`` as it is; a DISCRETE or
    SPOTS output basis returns 0."""
    pos = torch.from_numpy(_inputs()["pos"][:256] * np.float32(0.01))
    B = TN.Basis
    assert torch.equal(TN.turbulence(pos, 0.5, 0.25, SEED, 3.0, B.SPOTS, B.PERLIN),
                       TN.perlin_noise(pos, 0.25, SEED))
    assert not TN.turbulence(pos, 0.5, 0.25, SEED, 3.0, B.PERLIN, B.DISCRETE).any()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
