"""The shading's secondary rays around a caller's tracer
(``ops/secondary.py::secondary_traced``): on the card a build launch, one
call of the tracer (AO's samples as one batch) and for AO a reduce launch
(``csrc/secondary.cu`` over ``csrc/secondary.cuh``, ``kernels/secondary.py``);
on the CPU ``secondary_plain``, whose parts are the plain versions,
``secondary_rays_plain`` and ``secondary_reduce_plain``.

On the 64^3 world at factor 8 of ``tests/test_torch_frame_kernels.py``, a
64x48 frame's plain primary trace: each kind (shadow, reflection, AO at 1
and 4 samples) through ``secondary_traced`` over the plain walk equals
``secondary_plain`` (one tracer call a sample for AO) and the JAX package's
secondary inputs (its shadow and reflection traces and
``_ambient_occlusion`` over its XLA walk), bit for bit; so does the card's
route (AO's samples in one batch) through the kernels' host twins
(``dda_host.cpp``, built by g++).
The twins of the build and the reduce are also held to the plain versions
on inputs with NaN and signed zeros (primary positions, normals and
directions, the light, the tracer's positions).  The JAX side runs once,
in a subprocess whose XLA:CPU neither contracts FMAs nor runs the
algebraic simplifier (``tests/test_torch_render.py`` module doc).  On the
card: the kernels against the plain versions.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import Environment, RenderConfig
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels import secondary as secondary_kernel
from voxelengine_tpu_torch.ops import secondary
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
EULER = np.array([-0.5, 0.8, 0.0], np.float32)
FRAME = 3
MAX_STEPS = 128
BASE = dict(width=64, height=48, checkerboard=True, tile_order=True, max_steps=MAX_STEPS, shadow_rays=True,
            reflections=True)
AO_SAMPLES = (1, 4)
KINDS = ("shadow", "reflection", "ao")


def _world():
    """``tests/test_torch_frame_kernels.py``'s 64^3 world: a sparse field over a floor."""
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _jax_reference():
    """JAX side (runs in the subprocess, module doc): the frame's primary
    rays and trace, and each kind's secondary inputs as its
    ``shade_traced`` computes them over the XLA walk."""
    import jax.numpy as jnp

    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as jbuild
    from voxelengine_tpu.core.layout import Layout as JLayout
    from voxelengine_tpu.ops.trace import trace_brickmap as jtrace
    from voxelengine_tpu.render import frame as jframe
    from voxelengine_tpu.render.shading import reflect as jreflect

    out = {}
    bm = jbuild(JGrid.from_dense(_world()), 8, coarse_layout=JLayout.LINEAR)
    env = JEnv.default()
    for ao in AO_SAMPLES:
        cfg = JCfg(staged_trace=False, ao_samples=ao, **BASE)
        o, d, px, py = jframe.primary_rays(cfg, jnp.asarray(ORIGIN), jnp.asarray(EULER), jnp.int32(FRAME))[:4]
        res = jtrace(bm, o, d, cfg.max_steps)
        normal = -res.normal
        out[f"ao/{ao}"] = np.asarray(jframe._ambient_occlusion(bm, res.position, normal, px, py, jnp.int32(FRAME),
                                                                cfg))
    L = env.light_direction
    sres = jtrace(bm, res.position + L * 0.01, jnp.broadcast_to(L, normal.shape), cfg.max_steps)
    rres = jtrace(bm, res.position + normal * 0.01, jreflect(d, normal), cfg.max_steps)
    out.update({"primary/origins": o, "primary/dirs": d, "primary/px": px, "primary/py": py,
                "shadow/0": sres.hit, "shadow/1": sres.steps,
                "reflection/0": rres.hit, "reflection/1": rres.position, "reflection/2": rres.normal})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "secondary_traced_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _equal(got, want, what, nan_equal=False):
    """Bit for bit (float32 as int32 words); with ``nan_equal`` any NaN
    equals any NaN (the payload is the instruction's, not the function's),
    signed zeros still compared by sign."""
    got, want = _tuple(got), _tuple(want)
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.contiguous().cpu(), w.contiguous().cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape, w.shape)
        if nan_equal and g.dtype.is_floating_point:
            nan = torch.isnan(g)
            assert torch.equal(nan, torch.isnan(w)), (what, k)
            g, w = torch.where(nan, 0.0, g), torch.where(nan, 0.0, w)
        assert torch.equal(_words(g), _words(w)), (what, k)


def _case(ao, dev="cpu"):
    """``(walk, args of secondary_traced after the tracer, cfg)`` of the
    frame: its plain primary trace on ``dev`` and the plain walk."""
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(_world()).to(dev)), 8, coarse_layout=Layout.LINEAR)
    cfg = RenderConfig(ao_samples=ao, **BASE)
    o, d, px, py, _ = frame.primary_rays_plain(cfg, _t(ORIGIN).to(dev), _t(EULER).to(dev), FRAME)
    out = trace_brickmap(bm, o, d, MAX_STEPS)
    env = Environment.default(device=dev)

    def walk(a, b, ms):
        return trace_brickmap(bm, a, b, ms)

    return walk, (out, d, px, py, env, FRAME, cfg), cfg


def _counting(walk, calls):
    def run(o, d, ms):
        calls.append((o.shape[0], ms))
        return walk(o, d, ms)
    return run


def _jax_inputs(ref, kind, ao):
    if kind == "ao":
        return _t(ref[f"ao/{ao}"])
    n = 3 if kind == "reflection" else 2
    return tuple(_t(ref[f"{kind}/{k}"]) for k in range(n))


class _HostKernels:
    """``kernels/secondary.py``'s launchers as their host entries (the same
    arguments less the stream, which the route's ``launch`` drops)."""

    def __init__(self):
        dda = build.load_dda_host()
        self.vx_secondary_build = dda.vx_secondary_build_host
        self.vx_secondary_reduce = dda.vx_secondary_reduce_host


@pytest.fixture
def host_route(monkeypatch):
    """CPU primary traces take the card's route through the host twins:
    returns the list of launches made, by kernel name."""
    seen = []
    kernels = _HostKernels()

    def launch(kernel, fn, *args, dev):
        seen.append(kernel)
        assert fn(*args) == 0

    monkeypatch.setattr(secondary, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", launch)
    return seen


def test_primary_rays_are_jax_s(ref):
    """The case's inputs: the port's plain primary rays are JAX's."""
    _, (out, d, px, py, *_), cfg = _case(1)
    o, _, _, _, _ = frame.primary_rays_plain(cfg, _t(ORIGIN), _t(EULER), FRAME)
    want = tuple(_t(ref[f"primary/{k}"]) for k in ("origins", "dirs", "px", "py"))
    _equal((o.expand_as(d), d, px, py), want[:2] + tuple(t.long() for t in want[2:]), "primary rays")
    assert bool(out.hit.any()) and not bool(out.hit.all())


@pytest.mark.parametrize("ao", AO_SAMPLES)
@pytest.mark.parametrize("kind", KINDS)
def test_secondary_traced_plain_equals_secondary_plain_and_jax(ref, kind, ao):
    """On the CPU ``secondary_traced`` is ``secondary_plain`` (one tracer
    call a kind, a sample for AO, at 8 steps): its results and JAX's, bit
    for bit."""
    walk, args, cfg = _case(ao)
    n = args[0].position.shape[0]
    calls, plain_calls = [], []
    got = secondary.secondary_traced(kind, _counting(walk, calls), *args)
    want = secondary.secondary_plain(kind, _counting(walk, plain_calls), *args)
    steps = 8 if kind == "ao" else MAX_STEPS
    assert calls == plain_calls == [(n, steps)] * (ao if kind == "ao" else 1)
    _equal(got, want, (kind, ao, "secondary_plain"))
    _equal(got, _jax_inputs(ref, kind, ao), (kind, ao, "JAX"))


@pytest.mark.parametrize("ao", AO_SAMPLES)
@pytest.mark.parametrize("kind", KINDS)
def test_secondary_traced_twins_equal_plain_and_jax(ref, host_route, kind, ao):
    """The card's route through the host twins of the build and the reduce:
    one build launch, one tracer call (AO's samples as one batch of N *
    ao_samples rays), and for AO one reduce launch; the results are
    ``secondary_plain``'s (one call a sample) and JAX's, bit for bit."""
    walk, args, cfg = _case(ao)
    n = args[0].position.shape[0]
    reduces = int(kind == "ao")
    before = (secondary_kernel.build_launches, secondary_kernel.reduce_launches)
    calls = []
    got = secondary.secondary_traced(kind, _counting(walk, calls), *args)
    assert host_route == ["secondary_build"] + ["secondary_reduce"] * reduces
    assert calls == [(n * ao if kind == "ao" else n, 8 if kind == "ao" else MAX_STEPS)]
    assert (secondary_kernel.build_launches, secondary_kernel.reduce_launches) == (before[0] + 1, before[1] + reduces)
    _equal(got, secondary.secondary_plain(kind, walk, *args), (kind, ao, "secondary_plain"))
    _equal(got, _jax_inputs(ref, kind, ao), (kind, ao, "JAX"))


def _special(args, seed, dev="cpu"):
    """The case's primary trace and directions with NaN, signed zeros and
    far values in positions, normals and directions, and a light with a
    signed zero; drawn from a numpy seed."""
    out, d, px, py, env, fn, cfg = args
    n = out.position.shape[0]
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -2.5, np.nan, 1e30, -1e-30, 40.0], np.float32)

    def special(base):
        mask = torch.from_numpy(rng.random((n, 1)) < 0.3).to(dev)
        return torch.where(mask, torch.from_numpy(pool[rng.integers(len(pool), size=(n, 3))]).to(dev), base)

    out = TraceOut(out.hit, special(out.position), special(out.normal), out.steps)
    env = Environment(light_direction=_t(np.array([-0.0, 0.6, 0.8], np.float32)).to(dev),
                      light_color=env.light_color, ambient_color=env.ambient_color)
    return out, special(d), px, py, env, fn, cfg


def _special_trace(m, seed, dev="cpu"):
    """A tracer's result for ``m`` rays with NaN, signed zeros and far
    values in its positions and normals."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 3.0, -7.25, 12.5, np.nan, 1e30, -1e-30, 63.9, 0.004], np.float32)
    return TraceOut(torch.from_numpy(rng.random(m) < 0.6).to(dev),
                    torch.from_numpy(pool[rng.integers(len(pool), size=(m, 3))]).to(dev),
                    torch.from_numpy(pool[rng.integers(len(pool), size=(m, 3))]).to(dev),
                    torch.from_numpy(rng.integers(0, 300, m).astype(np.int32)).to(dev))


def _build_and_reduce(kind, args, res):
    """The wrappers' build on ``args``, and for AO their reduce of the
    tracer result ``res`` (None for a shadow or a reflection)."""
    out, d, px, py, env, fn, cfg = args
    rays = secondary_kernel.secondary_build(kind, out.position, out.normal, light=env.light_direction,
                                            dirs=d, px=px, py=py, width=cfg.width, frame_number=fn,
                                            ao_samples=cfg.ao_samples)
    if kind != "ao":
        return rays, None
    return rays, secondary_kernel.secondary_reduce(out.position, res.hit, res.position, ao_samples=cfg.ao_samples)


@pytest.mark.parametrize("ao", AO_SAMPLES)
@pytest.mark.parametrize("kind", KINDS)
def test_build_and_reduce_twins_signed_zeros_and_nans(host_route, kind, ao):
    """The twins of ``vx_secondary_build`` (each kind) and
    ``vx_secondary_reduce`` (AO) against ``secondary_rays_plain`` and
    ``secondary_reduce_plain`` on inputs with NaN and signed zeros, bit for
    bit (NaN equal to NaN)."""
    _, args, cfg = _case(ao)
    args = _special(args, 31 + ao)
    out = args[0]
    m = secondary_kernel.ray_count(kind, out.position.shape[0], ao)
    res = _special_trace(m, 41 + ao)
    got_rays, got = _build_and_reduce(kind, args, res)
    want_rays = secondary.secondary_rays_plain(kind, *args)
    _equal(got_rays, tuple(t.expand(m, 3) for t in want_rays), (kind, ao, "build"), nan_equal=True)
    assert any(bool(torch.isnan(t).any()) for t in want_rays)
    if kind == "ao":
        want = secondary.secondary_reduce_plain(kind, res, out, cfg)
        _equal((got,), (want,), (kind, ao, "reduce"), nan_equal=True)
        assert bool(torch.isnan(want).any()) and bool((want == 1.0).any())


def test_wrappers_refuse_cpu_tensors_and_bad_inputs():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        secondary_kernel.secondary_build("shadow", z, z, light=torch.zeros(3))
    hit = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        secondary_kernel.secondary_reduce(z, hit, z, ao_samples=1)
    with pytest.raises(ValueError, match="kind"):
        secondary_kernel.secondary_build("glow", z, z)
    assert secondary_kernel.ray_count("ao", 5, 4) == 20 and secondary_kernel.ray_count("shadow", 5, 4) == 5


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ao", AO_SAMPLES)
def test_secondary_traced_on_card_equals_secondary_plain(cuda_device, ao):
    """The build and reduce kernels around the plain walk against
    ``secondary_plain`` over the same walk, each kind, bit for bit, and
    their launches (a reduce for AO only)."""
    walk, args, cfg = _case(ao, cuda_device)
    for kind in KINDS:
        before = (secondary_kernel.build_launches, secondary_kernel.reduce_launches)
        got = secondary.secondary_traced(kind, walk, *args)
        after = (before[0] + 1, before[1] + int(kind == "ao"))
        assert (secondary_kernel.build_launches, secondary_kernel.reduce_launches) == after
        _equal(got, secondary.secondary_plain(kind, walk, *args), (kind, ao))


@pytest.mark.cuda
@pytest.mark.parametrize("ao", AO_SAMPLES)
def test_build_and_reduce_kernels_signed_zeros_and_nans_on_card(cuda_device, ao):
    """The kernels against the plain versions on the inputs of
    :func:`test_build_and_reduce_twins_signed_zeros_and_nans` (the AO
    falloff's clamps are ``fmaxf``/``fminf`` as torch's CUDA clamps)."""
    _, args, cfg = _case(ao, cuda_device)
    args = _special(args, 31 + ao, cuda_device)
    out = args[0]
    for kind in KINDS:
        m = secondary_kernel.ray_count(kind, out.position.shape[0], ao)
        res = _special_trace(m, 41 + ao, cuda_device)
        got_rays, got = _build_and_reduce(kind, args, res)
        want_rays = secondary.secondary_rays_plain(kind, *args)
        _equal(got_rays, tuple(t.expand(m, 3) for t in want_rays), (kind, ao, "build"), nan_equal=True)
        if kind == "ao":
            _equal((got,), (secondary.secondary_reduce_plain(kind, res, out, cfg),), (kind, ao, "reduce"),
                   nan_equal=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
