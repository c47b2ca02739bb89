"""The PyTorch port's worldgen noise against ``native/golden_noise.json``
(an independent C++ build of the reference's semantics) and the JAX package.

hash, random_float and perlin are bit-exact against both.  The port also
matches the golden repeater_perlin and terrain_t bit for bit: eager torch
runs every op on its own and contracts nothing, like the reference.  The
JAX package matches them only to ~1 ulp on the CPU (XLA:CPU contracts one
FMA in the octave loop, ``tests/test_noise.py:56-58``), so the port is held
against JAX at that file's tolerance.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelengine_tpu.ops import noise as JN
from voxelengine_tpu_torch.ops import noise as TN

GOLDEN = json.loads((Path(__file__).resolve().parent.parent / "native" / "golden_noise.json").read_text())
HSEEDS = np.array([0, 1, 42, 0x71889283, 0xFFFFFFFF, 123456789], np.uint32)
COORDS = np.array(
    [[0.1, 0.2, 0.3], [1.5, 2.5, 3.5], [10, 20, 30], [0.005, 0, 0], [100.7, 3.3, 77.77]],
    np.float32,
)


def _seeds():
    return torch.from_numpy(HSEEDS.astype(np.int64))


def test_hash_bit_exact():
    got = TN.hash_u32(_seeds()).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.array(GOLDEN["hash"], np.uint32))
    np.testing.assert_array_equal(got, np.asarray(JN.hash_u32(HSEEDS)))
    # int32 bit patterns hash like the uint32 they stand for
    np.testing.assert_array_equal(TN.hash_u32(torch.from_numpy(HSEEDS.view(np.int32))).numpy(), got)


def test_random_float_bit_exact():
    got = TN.random_float(_seeds()).numpy()
    np.testing.assert_array_equal(got, np.array(GOLDEN["random_float"], np.float32))
    np.testing.assert_array_equal(got, np.asarray(JN.random_float(HSEEDS)))


def test_perlin_bit_exact():
    got = TN.perlin_noise(torch.from_numpy(COORDS), 1.0, 1040580316).numpy()
    np.testing.assert_array_equal(got, np.array(GOLDEN["perlin"], np.float32))
    np.testing.assert_array_equal(got, np.asarray(JN.perlin_noise(jnp.asarray(COORDS), 1.0, 1040580316)))


def test_perlin_bit_exact_on_random_points(rng):
    pos = (rng.random((512, 3)) * 200 - 100).astype(np.float32)
    for seed in (0, 27389482 * 40, -5):
        got = TN.perlin_noise(torch.from_numpy(pos), 1.0, seed).numpy()
        want = np.asarray(JN.perlin_noise(jnp.asarray(pos), 1.0, seed))
        np.testing.assert_array_equal(got, want)


def test_repeater_perlin_matches_golden_bit_exact_and_jax_within_tolerance():
    got = TN.repeater_perlin(torch.from_numpy(COORDS), 1.0, 0x71889283, 32, 2.0, 0.5).numpy()
    np.testing.assert_array_equal(got, np.array(GOLDEN["repeater_perlin"], np.float32))
    want = np.asarray(JN.repeater_perlin(jnp.asarray(COORDS), 1.0, 0x71889283, 32, 2.0, 0.5))
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-7)


def test_repeater_perlin_ignores_seed():
    a = TN.repeater_perlin(torch.from_numpy(COORDS), 1.0, 1, 4, 2.0, 0.5)
    b = TN.repeater_perlin(torch.from_numpy(COORDS), 1.0, 999, 4, 2.0, 0.5)
    assert torch.equal(a, b)


def test_terrain_density_matches_golden_and_jax():
    from voxelengine_tpu.worldgen.terrain import terrain_density as j_td
    from voxelengine_tpu_torch.worldgen.terrain import terrain_density as t_td

    z, y, x = np.meshgrid(np.arange(4) * 37, np.arange(4) * 37, np.arange(4) * 37, indexing="ij")
    got = t_td(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z)).numpy().reshape(-1)
    np.testing.assert_array_equal(got, np.array(GOLDEN["terrain_t"], np.float32))
    want = np.asarray(j_td(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=1e-4)


def test_solid_at_matches_jax(rng):
    from voxelengine_tpu.worldgen.terrain import solid_at as j_solid
    from voxelengine_tpu_torch.worldgen.terrain import solid_at as t_solid

    x, z = rng.integers(0, 4096, 300), rng.integers(0, 4096, 300)
    y = rng.integers(0, 160, 300)
    got = t_solid(*(torch.from_numpy(v) for v in (x, y, z)), octaves=8).numpy()
    want = np.asarray(j_solid(*(jnp.asarray(v) for v in (x, y, z)), octaves=8))
    np.testing.assert_array_equal(got, want)


def test_conversion_saturation():
    vals = torch.tensor([-5.0, 0.0, 1.9, 4.5e9, float("nan"), 2147483000.0])
    u = TN.f32_to_u32_sat(vals).numpy()
    assert list(u[:5]) == [0, 0, 1, 0xFFFFFFFF, 0]
    i = TN.f32_to_i32_sat(vals).numpy()
    assert i.dtype == np.int32
    assert i[0] == -5 and i[2] == 1 and i[3] == 2147483647 and i[4] == 0
    assert i[5] == 2147483008
    assert TN.f32_to_u32_sat(torch.tensor([4294967040.0])).item() == 4294967040
    np.testing.assert_array_equal(u, np.asarray(JN.f32_to_u32_sat(vals.numpy())))
    np.testing.assert_array_equal(i, np.asarray(JN.f32_to_i32_sat(vals.numpy())))


@pytest.mark.parametrize("h", range(16))
def test_grad_table_bit_equal_including_quirks(h):
    x, y, z = torch.tensor(2.0), torch.tensor(3.0), torch.tensor(5.0)
    got = TN.grad(torch.tensor(h), x, y, z).item()
    assert got == float(np.asarray(JN.grad(jnp.uint32(h), 2.0, 3.0, 5.0)))


def test_fade_lerp_random_int_grid_bit_equal(rng):
    t = rng.random(1000).astype(np.float32)
    np.testing.assert_array_equal(TN.fade(torch.from_numpy(t)).numpy(), np.asarray(JN.fade(jnp.asarray(t))))
    a, b = (rng.random(1000).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        TN.lerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)).numpy(),
        np.asarray(JN.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))),
    )
    g = np.floor(rng.random((3, 1000)) * 2000 - 1000).astype(np.float32)
    got = TN.random_int_grid(*(torch.from_numpy(v) for v in g), 1234.0).numpy()
    want = np.asarray(JN.random_int_grid(*(jnp.asarray(v) for v in g), 1234.0))
    np.testing.assert_array_equal(got, want.astype(np.int64))
