"""K1's launch (``csrc/bigtrace.cu``): a persistent grid whose warps take 32
rays at a time from a work counter.

The CPU lane holds :func:`kernels.bigtrace.launch_grid`, the grid and the
count of batches handed out after the grid's first wave, against their
formula.  The card lane runs each K1 entry (rays, macro off and on, and its
diag build; record; the three secondary kinds) at the queue's edges
(1, 31 and 33 rays, exactly one resident wave, three waves and 5 rays), twice
back to back on one stream, and holds every result bit-equal to its host twin
(``csrc/dda_host.cpp``) and the launch's counters to the formula.
"""

import pytest
import torch

from torch_shared import terrain_128x64x128_f32_o3
from voxelengine_tpu_torch.config import Environment
from voxelengine_tpu_torch.kernels import bigtrace, build
from voxelengine_tpu_torch.ops import bigtrace as ops_bigtrace

MAX_STEPS = 256
H100_SMS = 132
WAVE = H100_SMS * 32  # warps an H100 holds at once: one 1024-thread block an SM (64 registers a thread)


@pytest.mark.parametrize("n, want", [
    (0, (0, 0)),
    (1, (1, 0)),
    (33, (1, 0)),
    (31 * 32 * 32, (31, 0)),
    (WAVE * 32, (H100_SMS, 0)),
    (WAVE * 32 + 1, (H100_SMS, 1)),
    (1920 * 1080 // 2, (H100_SMS, 32400 - WAVE)),  # the bench frame's checkerboard rays: 28,176 queued
    (3 * WAVE * 32 + 5, (H100_SMS, 2 * WAVE + 1)),
])
def test_launch_grid_counts_the_batches_after_the_first_wave(n, want):
    assert bigtrace.launch_grid(n, H100_SMS, 1) == want


def test_launch_grid_on_other_cards_and_blocks():
    """A launch's blocks never exceed what the card holds nor the blocks its
    batches fill, and every batch is in the first wave or queued."""
    for sms, per_sm, threads in ((1, 1, 1024), (2, 3, 128), (7, 6, 128), (132, 2, 512)):
        warps = threads // 32
        for n in range(0, 40000, 97):
            blocks, queued = bigtrace.launch_grid(n, sms, per_sm, threads)
            batches = -(-n // 32)
            assert blocks == min(-(-batches // warps), sms * per_sm)
            assert queued == batches - min(batches, sms * per_sm * warps)


def test_host_route_counts_the_launch_and_no_grid(monkeypatch, tmp_path_factory):
    """A host twin in the launcher's place reports no grid: the launch
    counts, the queue's counters stay."""
    bm = terrain_128x64x128_f32_o3(tmp_path_factory)
    lt = ops_bigtrace.make_line_table(bm)
    tables, kw = ops_bigtrace._kernel_tables(bm, lt, MAX_STEPS, False)
    _host_route(monkeypatch)
    o, d = _rays(100)
    before = (bigtrace.launches, bigtrace.grid_blocks, bigtrace.queued_batches)
    bigtrace.bigtrace_rays(o, d, *tables, **kw)
    assert (bigtrace.launches, bigtrace.grid_blocks, bigtrace.queued_batches) == (before[0] + 1, *before[1:])


# ------------------------------------------------------------ card lane

ENTRIES = ("rays", "rays macro", "rays macro diag", "record", "shadow", "reflection", "ao")
WIDTH = 1024  # the AO kind's pixel rows


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


class _HostKernels:
    """K1's launchers as their host twins: the same arguments less the
    work counter and grid (and the stream, which the route's ``launch``
    drops)."""

    def __init__(self):
        dda = build.load_dda_host()
        self.entries = {fn: getattr(dda, f"{fn}_host") for fn in build.K1_HOST}

    def __getattr__(self, fn):
        host = self.__dict__["entries"][fn]
        return lambda *a: host(*a[:-2])


def _host_route(monkeypatch):
    kernels = _HostKernels()
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", lambda kernel, fn, *args, dev: fn(*args))


def _rays(n):
    """Rays from the air over the terrain and around it, most of them
    downwards: walks of a few chunks and walks across the world."""
    g = torch.Generator().manual_seed(2024)
    o = torch.rand((n, 3), generator=g) * torch.tensor([192.0, 40.0, 192.0]) + torch.tensor([-32.0, 66.0, -32.0])
    d = torch.randn((n, 3), generator=g) - torch.tensor([0.0, 0.7, 0.0])  # most of them downwards
    return o, d / d.norm(dim=-1, keepdim=True)


def _entry(entry, tables, kw, o, d, primary):
    """``entry``'s call on rays ``o``, ``d`` (and, for a secondary kind,
    the primary trace ``primary``): the wrapper's outputs as a tuple."""
    macro = "macro" in entry
    if entry.startswith("rays"):
        return bigtrace.bigtrace_rays(o, d, *tables, **dict(kw, use_macro=macro), diag="diag" in entry)
    if entry == "record":
        return bigtrace.bigtrace_record(o, d, *tables, **kw)
    pos, nrm = primary
    n = o.shape[0]
    px = torch.arange(n, device=o.device) % WIDTH
    res = bigtrace.bigtrace_secondary(
        entry, pos, nrm, *tables, light=Environment.default(o.device).light_direction, dirs=d, px=px,
        py=torch.div(torch.arange(n, device=o.device), WIDTH, rounding_mode="floor"), width=WIDTH,
        frame_number=3, ao_samples=4, **dict(kw, max_steps=8 if entry == "ao" else MAX_STEPS, use_macro=False))
    return res if isinstance(res, tuple) else (res,)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_k1_queue_edges_equal_the_host_twins_on_card(cuda_device, tmp_path_factory, monkeypatch, entry):
    bm = terrain_128x64x128_f32_o3(tmp_path_factory)
    lt = ops_bigtrace.make_line_table(bm)
    cpu_tables, kw = ops_bigtrace._kernel_tables(bm, lt, MAX_STEPS, False)
    del kw["use_macro"]
    tables = tuple(None if t is None else t.to(cuda_device) for t in cpu_tables)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    per_sm, threads = 1, bigtrace.THREADS
    if "diag" in entry:  # 128-thread blocks at the compiler's own register budget
        threads = 128
        o, d = (t.to(cuda_device) for t in _rays(sms * 16 * 4 * 32 + 1))  # more warps than the card holds
        _entry(entry, tables, kw, o, d, None)
        per_sm, rest = divmod(bigtrace.grid_blocks, sms)
        assert rest == 0 and 1 <= per_sm <= 16
    wave = sms * per_sm * threads  # rays of one resident wave of warps
    sizes = (1, 31, 33, wave, 3 * wave + 5)
    o_all, d_all = _rays(sizes[-1])

    card = {}
    for n in sizes:
        o, d = o_all[:n].to(cuda_device), d_all[:n].to(cuda_device)
        primary = None
        if entry in build.SECONDARY_KINDS:
            out = bigtrace.bigtrace_rays(o, d, *tables, **dict(kw, use_macro=False))
            primary = (out[1], out[2])
        before = (bigtrace.launches, bigtrace.queued_batches)
        # twice back to back on one stream: the second launch's counter is zeroed behind the first
        runs = [_entry(entry, tables, kw, o, d, primary) for _ in range(2)]
        blocks, queued = bigtrace.launch_grid(n, sms, per_sm, threads)
        assert bigtrace.grid_blocks == blocks, (entry, n)
        assert (bigtrace.launches, bigtrace.queued_batches) == (before[0] + 2, before[1] + 2 * queued), (entry, n)
        card[n] = [[t.cpu() for t in run] for run in runs]
    assert bigtrace.launch_grid(sizes[-1], sms, per_sm, threads)[1] > 0  # the largest size queues

    _host_route(monkeypatch)
    for n in sizes:
        o, d = o_all[:n], d_all[:n]
        primary = None
        if entry in build.SECONDARY_KINDS:
            out = bigtrace.bigtrace_rays(o, d, *cpu_tables, **dict(kw, use_macro=False))
            primary = (out[1], out[2])
        want = _entry(entry, cpu_tables, kw, o, d, primary)
        for run in card[n]:
            assert len(run) == len(want)
            for k, (g, w) in enumerate(zip(run, want)):
                if "diag" in entry and k == 4:
                    # the host twin's last row is each ray's own iterations; the
                    # card's is the most of its warp batch, 32 consecutive rays
                    assert torch.equal(g[:-1], w[:-1]), (entry, n)
                    it = torch.nn.functional.pad(w[-1], (0, -n % 32)).view(-1, 32).amax(dim=1)
                    assert torch.equal(g[-1], it.repeat_interleave(32)[:n]), (entry, n)
                else:
                    assert torch.equal(_bits(g), _bits(w)), (entry, n, k)
