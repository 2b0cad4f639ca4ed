"""The fused two-block chunk: the port's plain version against the JAX
Pallas kernel, run in interpret mode as tests/test_kernels.py runs it on
the CPU.  The CUDA kernel is held against the plain version on a card in
tests/test_torch_gpu.py.

Tolerance 5e-4 absolute, the short-horizon bound of tests/test_kernels.py:
the two sides take the same f32 sums in another order, and that noise
random-walks through the prox's switching over 21 iterations."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from admmsolver_tpu.ops.kernels import fused_two_block_chunk as jax_chunk
from admmsolver_tpu_torch.ops.kernels import (fused_two_block_chunk,
                                              fused_two_block_chunk_reference)

torch.set_num_threads(1)

ATOL = 5e-4
PROX = ("l1", "l1_even", "nonneg", "nonneg_even")


def _inputs(thin, prox, B=8, N=128, seed=0):
    """Numpy chunk inputs (U, Ut, dinv, acy, mu, thr, x0, x1, h) from a
    basis-pursuit-like problem: the thin basis of a wide A (R=64) or the
    full eigenbasis of a tall one (R=N)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(64 if thin else 192, N)
    if thin:
        lam, W = np.linalg.eigh(A @ A.T)
        U = A.T @ W / np.sqrt(lam)
    else:
        lam, U = np.linalg.eigh(A.T @ A)
    mu = rng.uniform(0.5, 2.0, (B, 1))
    dinv = 1.0 / (lam[None, :] + mu)
    if thin:
        dinv = dinv - 1.0 / mu
    thr = 0.05 / mu if prox.startswith("l1") else np.zeros_like(mu)
    acy, x0, x1, h = (s * rng.randn(B, N) for s in (1.0, 0.3, 0.3, 1.0))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return [f32(a) for a in (U, U.T, dinv, acy, mu, thr, x0, x1, h)]


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
@pytest.mark.parametrize("prox", PROX)
def test_plain_version_matches_jax_kernel(prox, thin):
    args = _inputs(thin, prox)
    want = jax_chunk(*map(jnp.asarray, args), n_iters=21, prox=prox,
                     tile_b=8, interpret=True, thin=thin)
    launches = fused_two_block_chunk.launches
    got = fused_two_block_chunk(*map(torch.as_tensor, args), n_iters=21,
                                prox=prox, thin=thin)
    assert fused_two_block_chunk.launches == launches  # CPU: no kernel launch
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    if prox.endswith("_even"):
        assert np.all(got[1].numpy()[:, 1::2] == 0)


def test_chunk_returns_previous_iterate():
    """x0_prev is the x0 the last iteration started from; zero
    iterations return the input state."""
    args = [torch.as_tensor(a) for a in _inputs(True, "l1")]
    x0a, _, _, _ = fused_two_block_chunk(*args, n_iters=3, prox="l1", thin=True)
    state = args[6:]
    x0b, x1b, hb, prevb = fused_two_block_chunk(*args[:6], x0a, *state[1:], n_iters=0,
                                                prox="l1", thin=True)
    assert torch.equal(x0b, x0a) and torch.equal(prevb, x0a)
    two = fused_two_block_chunk(*args, n_iters=2, prox="l1", thin=True)
    three = fused_two_block_chunk(*args, n_iters=3, prox="l1", thin=True)
    assert torch.equal(three[3], two[0])


def test_chunk_rejects_bad_arguments():
    args = [torch.as_tensor(a) for a in _inputs(True, "l1")]
    with pytest.raises(ValueError, match="prox"):
        fused_two_block_chunk(*args, n_iters=1, prox="l2")
    with pytest.raises(TypeError, match="float32"):
        fused_two_block_chunk(*args[:8], args[8].double(), n_iters=1)
    with pytest.raises(ValueError, match="dinv"):
        fused_two_block_chunk(*args[:2], args[2][:, :-1], *args[3:], n_iters=1)
    with pytest.raises(ValueError, match="n_iters"):
        fused_two_block_chunk(*args, n_iters=-1)


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
@pytest.mark.parametrize("n_iters", [0, 1, 2, 3])
def test_short_chunks_match_jax_kernel(n_iters, thin):
    """The chunks in which x0_prev is the input x0 (0 and 1 iterations) or
    leaves the loop one iteration before its end (2 and 3), x0_prev
    included."""
    args = _inputs(thin, "l1", seed=1)
    want = jax_chunk(*map(jnp.asarray, args), n_iters=n_iters, prox="l1",
                     tile_b=8, interpret=True, thin=thin)
    got = fused_two_block_chunk(*map(torch.as_tensor, args), n_iters=n_iters,
                                prox="l1", thin=thin)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    if n_iters <= 1:
        assert np.array_equal(got[3].numpy(), args[6])


H100_SMEM = 232448  # opt-in shared memory per block of an H100, in bytes


@pytest.mark.parametrize("N,R,want", [
    # chip_smoke's shape: 32 lanes on mma.sync, three 32-row k-tiles, pairs of blocks
    (512, 256, (32, 32, 3, 2, 1)),
    # a small full basis (R <= 128): the wgmma kernel with the deepest rings
    (128, 128, (32, 32, 4, 1, 2)),
    # R not a multiple of 4: no bulk copies, hence no cluster
    (100, 50, (32, 32, 4, 1, 2)),
    # 32 lanes fit with shallower k-tiles only
    (1024, 512, (32, 16, 2, 2, 1)),
    # 32 lanes do not fit: the FMA kernel at fewer lanes
    (2048, 2048, (8, 16, 2, 2, 0)),
    (20000, 1000, (1, 16, 4, 2, 0)),
])
def test_two_block_tiling_choice(N, R, want):
    """The wrapper's choice needs no built library: lanes per block, k-tile
    depth, stages, cluster and route from N, R and a shared-memory limit."""
    from admmsolver_tpu_torch.ops.kernels import (TwoBlockTiling, _two_block_smem_bytes,
                                                  _two_block_tiling)

    got = _two_block_tiling(N, R, H100_SMEM)
    assert got == TwoBlockTiling(*want)
    assert _two_block_smem_bytes(got.lanes, N, R, got.kt, got.stages,
                                 got.tensor_cores) <= H100_SMEM
    # one more stage, or the next larger lane tile, would not fit
    if got.stages < 4:
        assert _two_block_smem_bytes(got.lanes, N, R, got.kt, got.stages + 1,
                                     got.tensor_cores) > H100_SMEM
    if got.lanes < 32:
        assert _two_block_smem_bytes(2 * got.lanes, N, R, 16, 2,
                                     int(2 * got.lanes == 32)) > H100_SMEM
    assert _two_block_tiling(N, R, H100_SMEM, aligned=False).cluster == 1


@pytest.mark.parametrize("N,R,want", [
    # the benchmark's shape (bp.fused_f32): wgmma, two rings of three stages, no cluster
    (1000, 100, (32, 32, 3, 1, 2)),
    # the widest thin basis the wgmma kernel takes
    (1000, 128, (32, 32, 3, 1, 2)),
    (256, 128, (32, 32, 4, 1, 2)),
    # one past it, and chip_smoke's N=512, R=256: the mma.sync kernel
    (1000, 129, (32, 32, 2, 1, 1)),
    (1000, 132, (32, 32, 2, 2, 1)),
    # v of N = 1200 leaves no room for two stages: the mma.sync kernel
    (1200, 100, (32, 16, 3, 2, 1)),
    # R or N not a multiple of 4: no bulk copies (the wgmma kernel's plain loads)
    (998, 97, (32, 32, 3, 1, 2)),
    (998, 100, (32, 32, 3, 1, 2)),
    (1000, 97, (32, 32, 3, 1, 2)),
    # 32 lanes do not fit: the FMA kernel
    (2048, 2048, (8, 16, 2, 2, 0)),
])
def test_two_block_route_choice(N, R, want):
    """R <= 128 takes the wgmma kernel wherever its two rings fit two
    stages; a wider basis the mma.sync kernel, and fewer than 32 lanes the
    FMA kernel, as before."""
    from admmsolver_tpu_torch.ops.kernels import (TWO_BLOCK_ROUTES, TwoBlockTiling,
                                                  _two_block_smem_bytes, _two_block_tiling)

    got = _two_block_tiling(N, R, H100_SMEM)
    assert got == TwoBlockTiling(*want)
    assert _two_block_smem_bytes(got.lanes, N, R, got.kt, got.stages,
                                 got.tensor_cores) <= H100_SMEM
    if TWO_BLOCK_ROUTES[got.tensor_cores] == "wgmma":
        assert R <= 128
        if got.stages < 4:
            assert _two_block_smem_bytes(32, N, R, 32, got.stages + 1, 2) > H100_SMEM
    else:
        assert R > 128 or _two_block_smem_bytes(32, N, R, 32, 2, 2) > H100_SMEM


def test_two_block_wgmma_shared_memory():
    """The wgmma kernel's layout: v in 64-column slices, w and its tail in
    32-column atoms, two tail slices, two rings of 8 KiB stages, mu, 1/mu and
    thr, two barriers per stage and ring, and the 1024-byte alignment margin."""
    from admmsolver_tpu_torch.ops.kernels import _two_block_smem_bytes

    atom = 32 * 32 * 4
    for N, R, stages in [(1000, 100, 3), (64, 32, 2), (97, 97, 4)]:
        atoms = 2 * -(-N // 64) + 2 * -(-R // 32) + 4
        want = 1024 + atoms * atom + 2 * stages * 8192 + 3 * 32 * 4 + 2 * stages * 2 * 8
        assert _two_block_smem_bytes(32, N, R, 32, stages, 2) == want
    assert _two_block_smem_bytes(32, 1000, 100, 32, 3, 2) == 230880


def test_two_block_tiling_limits():
    from admmsolver_tpu_torch.ops.kernels import _two_block_tiling

    # half the shared memory: half the lanes at the bench shape, on the FMA kernel
    assert _two_block_tiling(512, 256, H100_SMEM // 2)[::4] == (16, 0)
    # the FMA kernel at 32 lanes is built for 32-row k-tiles only
    assert _two_block_tiling(512, 256, H100_SMEM, tensor_cores=False) == (32, 32, 2, 2, 0)
    assert _two_block_tiling(1024, 512, H100_SMEM, tensor_cores=False)[::4] == (16, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _two_block_tiling(40000, 40000, H100_SMEM)


class _FakeTwoBlockLibrary:
    """The C interface of the two-block kernel's library, recording each
    launch's tiling instead of launching: the wrapper's path to the launch
    and its counters run on the CPU."""

    def __init__(self, smem_limit):
        self.smem_limit = smem_limit
        self.tilings = []

    def fused_two_block_max_smem(self, device, limit):
        limit._obj.value = self.smem_limit
        return 0

    def fused_two_block_launch(self, *args):
        self.tilings.append(tuple(args[-6:-1]))
        return 0

    def fused_two_block_error_string(self, err):
        return b"no launch"


@pytest.mark.parametrize("N,R,smem,route", [
    (1000, 100, H100_SMEM, "wgmma"),      # the benchmark's shape
    (998, 97, H100_SMEM, "wgmma"),        # ragged: the same route without a cluster
    (512, 256, H100_SMEM, "mma_sync"),    # chip_smoke's shape
    (512, 256, H100_SMEM // 2, "fma"),    # 16 lanes a block
])
def test_two_block_route_counters(monkeypatch, N, R, smem, route):
    """Each launch counts once in ``launches`` and once in its route's
    counter, which telemetry reports as ``kernel.fused_two_block_chunk.
    <route>.launches``; an mma.sync tiling given for a thin basis counts on
    the mma.sync route."""
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.utils import telemetry

    lib = _FakeTwoBlockLibrary(smem)
    monkeypatch.setattr(_build, "load_libraries", lambda: {"fused_two_block": lib})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    B = 3
    args = [torch.zeros(shape) for shape in ((N, R), (R, N), (B, R), (B, N), (B, 1), (B, 1),
                                             (B, N), (B, N), (B, N))]
    routes = kernels.fused_two_block_chunk.routes
    before = {name: c.launches for name, c in routes.items()}
    launches = kernels.fused_two_block_chunk.launches
    telemetry.reset()
    kernels._two_block_launch(args, 5, "l1", True)
    assert lib.tilings[-1] == tuple(kernels._two_block_tiling(N, R, smem))
    assert kernels.fused_two_block_chunk.launches == launches + 1
    assert {name: c.launches - before[name] for name, c in routes.items()} == \
        {name: int(name == route) for name in routes}
    counters = telemetry.snapshot()["counters"]
    assert counters["kernel.fused_two_block_chunk.launches"] == 1
    for name in routes:
        assert counters[f"kernel.fused_two_block_chunk.{name}.launches"] == int(name == route)

    kernels._two_block_launch(args, 5, "l1", True, kernels.TwoBlockTiling(32, 32, 2, 1, 1))
    assert lib.tilings[-1] == (32, 32, 2, 1, 1)
    assert routes["mma_sync"].launches - before["mma_sync"] == 1 + int(route == "mma_sync")


def _c_params(source: str, function: str) -> list:
    """The parameter types of ``function``'s definition in ``source``, each
    as "ptr" or "int"."""
    import re

    m = re.search(rf"^\w[\w\s\*]*\b{function}\(([^)]*)\)\s*\{{", source, re.M)
    assert m, function
    kinds = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        kinds.append("ptr" if "*" in words else "int" if words[0] == "int" else words[0])
    return kinds


@pytest.mark.parametrize("name", ["fused_two_block", "fused_spm", "jacobi_eigh",
                                  "spm_factor_refresh"])
def test_c_interfaces_match_their_declarations(name):
    """Each library's launch and shared-memory functions take the arguments
    ``ops/_build.py`` declares for ctypes, in number and kind (a mismatch
    passes the stream in another argument's place on the card)."""
    import ctypes

    from admmsolver_tpu_torch.ops import _build

    source = (_build.SOURCE_DIR / f"{name}.cu").read_text()
    kind = lambda t: "ptr" if t is ctypes.c_void_p else "int" if t is ctypes.c_int else t
    for function, declared in ((f"{name}_launch", _build._LAUNCH_ARGTYPES[name]),
                               (f"{name}_smem_bytes", _build._SMEM_ARGTYPES[name])):
        assert _c_params(source, function) == [kind(t) for t in declared], function


@pytest.mark.parametrize("nl,nw,want", [
    # the spm.fused_f32 cell (portbench spm_nl30_nw61): 8 tiles of eight
    # frequencies, one for each of the block's 8 warps
    (30, 61, (0, 1)),
    # each side of the nw at which a warp's tiles double, and chip_smoke 3b's
    (30, 64, (0, 1)), (30, 65, (0, 2)), (30, 128, (0, 2)), (30, 129, (0, 4)), (30, 201, (0, 4)),
    # the widest the tensor-core kernel takes, and one past it in nw or nl
    (32, 256, (0, 4)), (30, 257, None), (33, 61, None),
    (1, 1, (0, 1)), (16, 9, (0, 1)),
])
def test_spm_tensor_core_tiling_choice(nl, nw, want):
    """The tensor-core kernel takes nl <= 32, nw <= 256; its warps take the
    fewest instantiated tiles of frequencies (1, 2 or 4) that cover
    ceil(nw / 8) tiles over 8 warps; wider problems go to the FMA kernel."""
    from admmsolver_tpu_torch.ops.kernels import _SPM_TC_TILES, _spm_route, _spm_tc_tiling

    got = _spm_tc_tiling(nl, nw)
    assert got == want
    if got is not None:
        tiles = -(-nw // 8)
        assert 8 * got[1] >= tiles
        assert all(8 * k < tiles for k in _SPM_TC_TILES if k < got[1])
        assert _spm_route(got) == "mma_sync"
    assert _spm_route((2, 16)) == "fma"


class _FakeSpMLibrary:
    """The C interface of the SpM kernel's library, recording each launch's
    tiling instead of launching: the wrapper's path to the launch and its
    counters run on the CPU.  Shared memory as ``csrc/fused_spm.cu`` counts
    it, under an H100's opt-in limit."""

    def __init__(self):
        self.tilings = []

    def fused_spm_max_smem(self, device, limit):
        limit._obj.value = H100_SMEM
        return 0

    def fused_spm_smem_bytes(self, lanes, nl, nw):
        if lanes == 0:
            nt = -(-nw // 8)
            return 4 * (2 * nt * 8 * 36 + 2 * nt * 128 + 4 * 128 + 2 * 656 + 4 * 256 + 5 * 16)
        nlp, nwp = -(-nl // 4) * 4, -(-nw // 4) * 4
        ld = nlp + 1
        return 4 * (nwp * ld + lanes * (5 * nlp + 2 * nwp + -(-nl * ld // 4) * 4))

    def fused_spm_launch(self, *args):
        self.tilings.append(tuple(args[-3:-1]))
        return 0

    def fused_spm_error_string(self, err):
        return b"no launch"


@pytest.mark.parametrize("nl,nw,route", [
    (30, 61, "mma_sync"),    # the benchmark's cell
    (30, 65, "mma_sync"),
    (30, 201, "mma_sync"),   # chip_smoke 3b
    (32, 256, "mma_sync"),
    (30, 257, "fma"),
    (33, 61, "fma"),
])
def test_spm_route_counters(monkeypatch, nl, nw, route):
    """Each launch counts once in ``launches`` and once in its route's
    counter, which telemetry reports as ``kernel.fused_spm_chunk.<route>.
    launches``; the launch takes the tiling ``_spm_tiling`` names."""
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.utils import telemetry

    lib = _FakeSpMLibrary()
    monkeypatch.setattr(_build, "load_libraries", lambda: {"fused_spm": lib})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {"multi_processor_count": 132})())
    B = 5
    args = [torch.zeros(shape) for shape in ((nw, nl), (B, nl, nl), (B, nl), (B, 2), (B, 1),
                                             (B, nl), (B, nl), (B, nw), (B, nl), (B, nw))]
    routes = kernels.fused_spm_chunk.routes
    before = {name: c.launches for name, c in routes.items()}
    launches = kernels.fused_spm_chunk.launches
    telemetry.reset()
    kernels._spm_launch(args, 5)
    assert lib.tilings[-1] == tuple(kernels._spm_tiling(lib, 0, B, nl, nw))
    assert (lib.tilings[-1] == kernels._spm_tc_tiling(nl, nw)) == (route == "mma_sync")
    assert kernels.fused_spm_chunk.launches == launches + 1
    assert {name: c.launches - before[name] for name, c in routes.items()} == \
        {name: int(name == route) for name in kernels.SPM_ROUTES}
    counters = telemetry.snapshot()["counters"]
    assert counters["kernel.fused_spm_chunk.launches"] == 1
    for name in kernels.SPM_ROUTES:
        assert counters[f"kernel.fused_spm_chunk.{name}.launches"] == int(name == route)
