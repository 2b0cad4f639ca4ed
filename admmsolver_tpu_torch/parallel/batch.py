"""Batched ADMM: solve many problem instances of one structure at once.

Counterpart of :mod:`admmsolver_tpu.parallel.batch`.  Independent problem
instances — per-frequency SpM problems, λ-path sweeps, compressed sensing
with many right-hand sides — are rows of one state: ``x[k]`` is ``(B, n_k)``
and every step of the engine (:meth:`~admmsolver_tpu_torch.optimizer.
ADMMPlan.iteration`) acts on all rows.  The reference solves one
``SimpleOptimizer`` at a time (``optimizer.py:302-320``).

Control flow: per-instance convergence inside a batch means masked lanes
whose state is frozen by ``where`` selects, while the loop keeps stepping
until *all* lanes are done.  Penalty updates stay per-instance (``mu`` is
``(B, npairs)``), but their *schedule* is iteration-count based and thus
shared, so the factors are refreshed at chunk boundaries: iteration 0, then
chunks of ``interval_update_mu`` iterations, each followed by a refresh —
the batched analogue of the reference's hash-keyed cache
(``objectivefunc.py:89-96``).  The schedule is a Python loop; the host reads
the done flags once per chunk, never per iteration, and not at all when no
lane can finish (``rtol <= 0`` and ``atol <= 0``).

The chunks after iteration 0 run through a static chunk program
(:class:`_ChunkProgram`, the JAX package's one compiled program of a solve,
``batch.py:251-470``): fixed buffers for the state, the chunk's work over
them, and on a CUDA device one captured CUDA graph a chunk length, replayed
once a chunk.  A solver keeps its programs in a cache like the JAX
package's (:data:`PROGRAM_CACHE_SIZE`, the oldest dropped first), and their
graphs in one memory pool (:class:`_GraphPool`).  The chunk runs directly,
without a graph, on the CPU, with :data:`CAPTURE_CHUNKS` off, and for a
model with a route that a graph cannot hold (:meth:`~admmsolver_tpu_torch.
models.objectivefunc.ObjectiveFunctionBase.capturable`).

Sharding (``sharding=batch_sharding(mesh)``): each rank of the mesh solves
its block of lanes on its own device, and the only collective of a solve is
the exit predicate: where the host reads the done flags, every rank sums its
count of lanes not done in one ``all_reduce``, so that all ranks run the
same chunks.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import ADMMConfig
from ..models.objectivefunc import any_not_pd, deferred_cholesky_checks, raise_if_not_pd
from ..models.problem import Model
from ..optimizer import ADMMPlan
from ..ops.linop import LaneOperators, _asarray, _real_dtype
from ..utils import telemetry

__all__ = ["BatchedSolver", "BatchResult"]

#: Whether solves on a CUDA device replay their chunks as captured graphs;
#: False runs each chunk of the program directly, as on the CPU.
#: ``chip_smoke.py`` and the card's tests set it for their comparisons.
CAPTURE_CHUNKS = True
#: Chunk programs a solver keeps, the oldest dropped first (the JAX
#: package's ``_compiled_cache``, ``batch.py:141,261-262``).
PROGRAM_CACHE_SIZE = 32


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _cast_like(dtype, a, device=None) -> torch.Tensor:
    """Cast ``a`` to the real/complex companion of ``dtype`` (floats to
    its real type, complex to its complex type) so a mixed-precision phase
    doesn't get silently re-promoted by f64 constants."""
    a = _asarray(a)
    real = _real_dtype(_as_dtype(dtype))
    if a.is_complex():
        tgt = torch.complex64 if real == torch.float32 else torch.complex128
    elif a.is_floating_point():
        tgt = real
    else:
        tgt = a.dtype
    return a.to(device=device, dtype=tgt)


def _to_state_dtype(a, dtype, device=None) -> torch.Tensor:
    """Cast user-supplied initial state to the solver state dtype.

    Complex input to a REAL-dtype solve is explicit, not silent: the
    reference initializes state as ``complex128`` zeros
    (``optimizer.py:151,159``), so all-zero-imag complex ``x0``/``h0``
    is accepted (via an explicit ``.real``), but any nonzero imaginary
    part raises instead of being discarded."""
    a = _asarray(a)
    if a.is_complex() and not dtype.is_complex:
        if bool(torch.any(a.imag != 0)):
            raise TypeError(
                "complex initial state passed to a real-dtype solve would "
                "discard its imaginary part; pass dtype=complex")
        a = a.real
    return a.to(device=device, dtype=dtype)


def _parse_record_residuals(record_residuals) -> Tuple[bool, int]:
    """Normalize the ``record_residuals`` knob to ``(record, stride)``.

    ``True`` → per-iteration histories; ``False`` → none; an int ``s >= 1``
    → every s-th iteration (shared by every batched and fused solve)."""
    if record_residuals is True:
        return True, 1
    if record_residuals is False:
        return False, 1
    stride = int(record_residuals)
    if stride < 1:
        raise ValueError(
            f"record_residuals stride must be >= 1, got {stride}")
    return True, stride


@dataclasses.dataclass
class BatchResult:
    """Final batch state.

    ``x``: tuple of (B, n_k) tensors; ``h``: tuple of (B, size_p) tensors;
    ``mu``: (B, npairs); ``iterations``: (B,) int32 per-lane executed
    iteration counts; ``converged``: (B,) bools; ``primal_residual``/
    ``dual_residual``: (B, hist) histories, NaN-padded past each lane's
    exit (mirrors the reference's per-iteration history lists,
    ``optimizer.py:312-314``).  The histories are float64 whatever the
    dtype of the phase that wrote them, as in the JAX package.
    """

    x: Tuple[torch.Tensor, ...]
    h: Tuple[torch.Tensor, ...]
    mu: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor
    #: global index of each lane in the batch (a sharded solve's result holds
    #: this rank's lanes); None: lane b is lane b of the batch
    lane_index: Optional[torch.Tensor] = None


def _lanewise(fn, *results: BatchResult) -> BatchResult:
    """``fn`` over the corresponding tensors of the results, field by field."""
    blocks = lambda name: tuple(fn(*t) for t in zip(*(getattr(r, name) for r in results)))
    rest = ("mu", "iterations", "converged", "primal_residual", "dual_residual")
    idx = [r.lane_index for r in results]
    return BatchResult(x=blocks("x"), h=blocks("h"),
                       **{name: fn(*(getattr(r, name) for r in results)) for name in rest},
                       lane_index=None if any(i is None for i in idx) else fn(*idx))


def _concat(parts: Sequence[BatchResult]) -> BatchResult:
    """Results of consecutive groups of lanes as one result."""
    return parts[0] if len(parts) == 1 else _lanewise(lambda *a: torch.cat(a), *parts)


def _trim(res: BatchResult, n: int) -> BatchResult:
    """The lanes of a result whose global index is below ``n``."""
    if res.lane_index is None:
        return _lanewise(lambda a: a[:n], res)
    keep = res.lane_index < n
    return _lanewise(lambda a: a[keep], res)


def _shift(res: BatchResult, offset: int) -> BatchResult:
    """A result of lanes ``offset`` on of a larger batch."""
    if res.lane_index is None:
        return res
    return dataclasses.replace(res, lane_index=res.lane_index + offset)


def _pad_last(a: torch.Tensor, pad_n: int) -> torch.Tensor:
    """``a`` with its last lane repeated ``pad_n`` more times."""
    if not pad_n:
        return a
    return torch.cat([a, a[-1:].expand((pad_n,) + tuple(a.shape[1:]))])


def _route_switches() -> tuple:
    """The module constants that choose a spectral route or a path of the
    Jacobi kernel: a captured graph keeps what they chose at its capture."""
    from ..ops import kernels, prox

    return (prox.USE_SIGN_ABOVE_JACOBI, prox.JACOBI_MAX_N, prox.JACOBI_MAX_N_F32,
            tuple(sorted(prox.SIGN_SCHEDULES.items())), kernels._JACOBI_WARP_MAX_N,
            kernels._JACOBI_TILE_N)


def _counted_kernels() -> tuple:
    """The kernel wrappers that count their launches."""
    from ..ops import kernels

    return (kernels.jacobi_eigh, kernels.fused_two_block_chunk, kernels.fused_spm_chunk)


def _leaves(v) -> List[torch.Tensor]:
    """The tensors of an objective's field (a tensor, lane operators, or a
    tuple or list of them) in a fixed order."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, LaneOperators):
        return [v.data]
    if isinstance(v, (tuple, list)):
        return [t for a in v for t in _leaves(a)]
    return []


def _fresh(v):
    """``v`` with every tensor of it a new contiguous copy."""
    if isinstance(v, torch.Tensor):
        return v.clone(memory_format=torch.contiguous_format)
    if isinstance(v, LaneOperators):
        out = copy.copy(v)
        out.data = _fresh(v.data)
        return out
    if isinstance(v, (tuple, list)):
        return type(v)(_fresh(a) for a in v)
    return v


class _GraphPool:
    """The memory of a solver's chunk graphs on one CUDA device: one
    ``torch.cuda.MemPool`` that every program of the solver captures into
    (their replays run one after another on the solver's stream, and no
    tensor of the pool outlives a capture), the side stream the captures
    run on, and the bytes the pool reserved.  The eager work of a solve
    whose program is warm (iteration 0, chunks without a graph) allocates
    from the pool too (:meth:`allocating`), so that a solver holds one
    working set of a solve, not one in the pool and one beside it."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if device.index is None else device
        self.stream = torch.cuda.Stream(self.device)
        self.mempool = torch.cuda.MemPool()
        #: the device memory the pool's captures reserved
        self.bytes = 0

    @contextlib.contextmanager
    def on_stream(self):
        """The pool's stream, ordered after and before the current one."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            current.wait_stream(self.stream)

    def end_failed_capture(self) -> None:
        """After a capture into the pool that raised: a capture whose end
        failed still routes the allocator to the pool and holds a use of
        it, and the allocator's next emptying of any pool would then stop
        the process (``captures_underway.empty()`` asserted); end both."""
        index = self.device.index
        try:
            torch._C._cuda_endAllocateToPool(index, self.mempool.id)
        except RuntimeError:
            return   # the capture's end had stopped the routing, and kept its use
        torch._C._cuda_releasePool(index, self.mempool.id)

    @contextlib.contextmanager
    def allocating(self):
        """Work on the pool's stream with its allocations from the pool:
        the tensors made inside must be dead before the next replay."""
        with self.on_stream(), torch.cuda.use_mem_pool(self.mempool, self.device):
            yield


def _keep(programs: Dict, key, program):
    """``program`` stored under ``key`` in a solver's cache of programs, the
    oldest dropped first once it holds :data:`PROGRAM_CACHE_SIZE`."""
    if len(programs) >= PROGRAM_CACHE_SIZE:
        programs.pop(next(iter(programs)))
    programs[key] = program
    return program


def _flags_read(done: torch.Tensor, failed: Optional[torch.Tensor] = None,
                mesh=None) -> bool:
    """Whether every lane is done, in one host read that also takes
    ``failed`` (a factorization's failure flag, raised here); over a
    ``mesh``, the lanes and flags of every rank by one ``all_reduce`` of the
    count of lanes not done and of the failures."""
    flags = torch.stack([(~done).sum(), (done.new_zeros(()) if failed is None
                                         else failed).to(torch.int64)])
    if mesh is not None:
        flags = mesh.all_reduce(flags)
    not_done, failures = flags.tolist()
    raise_if_not_pd(failures > 0)
    return not_done == 0


def _schedule(niter: int, interval: int):
    """The chunks of a one-program solve as (iterations, penalty update):
    iteration 0, the full chunks of ``interval``, the remainder (reference
    ``optimizer.py:319-320``: the update fires after iteration 0 and after
    every full chunk, never after the remainder)."""
    nfull, nrem = divmod(niter - 1, interval)
    return [(1, True)] + [(interval, True)] * nfull + ([(nrem, False)] if nrem else [])


def _captures(functions, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether a solve of ``functions`` (a state of ``dtype`` on ``device``)
    replays its chunks as captured graphs: with :data:`CAPTURE_CHUNKS`, on a
    CUDA device, where every objective declares its steps capturable."""
    return CAPTURE_CHUNKS and device.type == "cuda" and all(
        f.capturable(_real_dtype(dtype), device) for f in functions)


class _GraphProgram:
    """What every static chunk program shares: a chunk (:meth:`_chunk`, by
    a key that names its length and kind) that reads and writes only the
    program's buffers, run directly or, on a CUDA device, captured once a
    key into a graph of the solver's pool and replayed.  A program that
    holds one of these rather than deriving from it passes its chunk
    function as ``chunk``.

    On a CUDA device a captured solve runs the program's first chunk
    eagerly (libraries load, caches fill), then captures each key once
    into a graph of the solver's pool (:class:`_GraphPool`) and replays it
    once a chunk; a replay adds the kernel launches its capture counted.
    Otherwise (the CPU, :data:`CAPTURE_CHUNKS` off, a route a graph cannot
    hold) the chunk runs directly, from the pool where there is one and the
    program is warm.  A chunk that fails to capture raises."""

    def __init__(self, chunk=None) -> None:
        self.warm = False
        #: chunk key -> (graph, kernel launches of one replay)
        self.graphs: Dict = {}
        #: host seconds of each key's capture
        self.capture_s: Dict = {}
        self._chunk_fn = chunk

    def _chunk(self, key) -> None:
        self._chunk_fn(key)

    def _run_chunk(self, key, capture: bool, pool: Optional[_GraphPool]) -> None:
        """One chunk: with ``capture`` (and ``pool``) a replay of its graph,
        once the program is warm; else the chunk itself, from ``pool``
        where there is one and the program is warm."""
        if not (capture and self.warm):
            if pool is None:
                self._chunk(key)
            else:
                with pool.allocating() if self.warm else pool.on_stream():
                    self._chunk(key)
            if capture:
                # this key's graph, for the chunks after this one
                self._capture(key, pool)
            self.warm = True
            return
        if key not in self.graphs:
            self._capture(key, pool)
        graph, launches = self.graphs[key]
        graph.replay()
        for kernel, count in zip(_counted_kernels(), launches):
            kernel.launches += count

    def _capture(self, key, pool: _GraphPool) -> None:
        """Capture the chunk of ``key`` (nothing runs) into a graph of
        ``pool``; a chunk that a graph cannot hold raises."""
        kernels = _counted_kernels()
        before = [kernel.launches for kernel in kernels]
        # torch.cuda.graph empties the allocator's cache as it enters; done
        # here first, the reserved bytes then grow by the pool's alone
        torch.cuda.synchronize(pool.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(pool.device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(pool.device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(pool.device), \
                    torch.cuda.graph(graph, pool=pool.mempool.id, stream=pool.stream):
                self._chunk(key)
        except BaseException:
            pool.end_failed_capture()
            raise
        finally:
            launches = [kernel.launches - b for kernel, b in zip(kernels, before)]
            for kernel, b in zip(kernels, before):
                kernel.launches = b
            # a capture that fails leaves its stream current
            torch.cuda.set_stream(current)
        self.capture_s[key] = time.perf_counter() - t0
        pool.bytes += torch.cuda.memory_reserved(pool.device) - reserved
        self.graphs[key] = (graph, launches)


class _ChunkProgram(_GraphProgram):
    """The static chunk program of one cache key: the counterpart of the JAX
    package's compiled ``_build`` (``batch.py:345-470``) from the chunk after
    iteration 0 on.

    It owns the buffers a chunk reads and writes: the state x, h, mu, done,
    count and the histories, the per-solve fields of the bound objectives
    (overrides and what the prologue derives from them), the tolerances and
    the first global iteration of the chunk, all loaded per solve
    (:meth:`load`).  A chunk (:meth:`_chunk`) refactors from mu, runs its
    iterations and copies the results into the buffers; the factors live
    only inside it, so that old and new factors never coexist.  The penalty
    update fires at the chunk's last position only in a full chunk, so one
    program of each length serves every chunk of a solve; the history slot
    of each iteration is computed on the device.  The Cholesky
    factorizations keep their info on the device
    (:func:`~admmsolver_tpu_torch.models.objectivefunc.deferred_cholesky_checks`),
    gathered in :attr:`failed`.

    Its chunks are keyed by their length alone (:class:`_GraphProgram`).
    """

    def __init__(self, plan: ADMMPlan, cfg: ADMMConfig, template, functions, carry,
                 record: bool, stride: int, chunked_checks: bool, freeze: bool) -> None:
        super().__init__()
        self.plan, self.cfg = plan, cfg
        self.chunked_checks, self.freeze = chunked_checks, freeze
        # the fields a solve supplies: those its bound objectives do not share
        # with the template
        self._fields = [(k, name) for k, (f, t) in enumerate(zip(functions, template))
                        if f is not t for name, v in vars(f).items()
                        if v is not vars(t).get(name) and _leaves(v)]
        self.functions = list(functions)
        for k in {k for k, _ in self._fields}:
            self.functions[k] = copy.copy(functions[k])
        for k, name in self._fields:
            setattr(self.functions[k], name, _fresh(getattr(functions[k], name)))
        x, h, mu, _, done, count, pbuf, dbuf = carry
        self.x, self.h = tuple(map(_fresh, x)), tuple(map(_fresh, h))
        self.mu, self.done, self.count, self.pbuf, self.dbuf = map(
            _fresh, (mu, done, count, pbuf, dbuf))
        dev = mu.device
        self.tols = (mu.new_zeros(()), mu.new_zeros(()))
        self.record, self.stride = record, stride
        # the first global iteration of the chunk, and the chunk's offsets
        self.it = torch.ones(1, dtype=torch.long, device=dev)
        self.steps = torch.arange(cfg.interval_update_mu, device=dev)
        self.failed = torch.zeros((), dtype=torch.bool, device=dev)
        self.checks = False

    def load(self, functions, carry, tols, infos) -> None:
        """A solve's inputs into the buffers: its objectives' fields, the
        state after iteration 0, the tolerances and the infos of iteration
        0's factorizations (on the pool's stream when the solve's eager
        work allocates from it: nothing here allocates a lasting tensor)."""
        for k, name in self._fields:
            dst = _leaves(getattr(self.functions[k], name))
            src = _leaves(getattr(functions[k], name))
            if [t.shape for t in dst] != [t.shape for t in src]:
                raise ValueError(f"block {k} field {name}: the solve's tensors do not fit "
                                 "the program's")
            for d, t in zip(dst, src):
                d.copy_(t)
        x, h, mu, _, done, count, pbuf, dbuf = carry
        self.hist = pbuf.shape[1]
        for d, t in zip(self.x + self.h + (self.mu, self.done, self.count,
                                           self.pbuf[:, :self.hist], self.dbuf[:, :self.hist]),
                        x + h + (mu, done, count, pbuf, dbuf)):
            d.copy_(t)
        for d, t in zip(self.tols, tols):
            d.fill_(t)
        self.it.fill_(1)
        self.failed.fill_(False)
        if infos:
            self.checks = True
            self.failed.logical_or_(any_not_pd(infos))

    def reserve(self, hist: int) -> None:
        """History buffers of at least ``hist`` columns: longer ones than the
        program holds are new buffers, and so need new graphs."""
        if hist > self.pbuf.shape[1]:
            self.pbuf, self.dbuf = (torch.full((self.pbuf.shape[0], hist), float("nan"),
                                               dtype=self.pbuf.dtype, device=self.pbuf.device)
                                    for _ in range(2))
            self.graphs.clear()

    def _chunk(self, n: int) -> None:
        """Refactor from mu, then ``n`` iterations, their results copied
        into the buffers.  The penalty schedule repeats every chunk, so the
        iterations take the first chunk's global indices 1..n."""
        plan, cfg = self.plan, self.cfg
        with deferred_cholesky_checks() as infos:
            factors = plan.compute_factors(self.mu, self.functions, batched=True)
        if infos:
            self.checks = True
            self.failed.logical_or_(any_not_pd(infos))
        carry = (self.x, self.h, self.mu, factors, self.done, self.count, self.pbuf, self.dbuf)
        slots = torch.div(self.it + self.steps[:n], self.stride,
                          rounding_mode="floor") if self.record else None
        last = cfg.interval_update_mu - 1
        for j in range(n):
            # each iteration steps the buffers: the previous state is theirs,
            # so a chunk holds one new state at a time beside them
            x, h, mu, _, done, count = plan.iteration(
                carry, slots[j:j + 1] if self.record else 0, 1 + j, cfg, self.tols,
                self.functions, compute_residuals=not self.chunked_checks or j == last,
                freeze=self.freeze)[:6]
            for d, t in zip(self.x + self.h + (self.mu, self.done, self.count),
                            x + h + (mu, done, count)):
                d.copy_(t)
            del x, h, mu, done, count
        self.it.add_(cfg.interval_update_mu)

    def run(self, n: int, capture: bool, pool: Optional[_GraphPool]) -> None:
        """One chunk of ``n`` iterations (:meth:`_GraphProgram._run_chunk`)."""
        self._run_chunk(n, capture, pool)

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the program holds between solves."""
        return self.x + self.h + (self.mu, self.done, self.count, self.pbuf, self.dbuf) + tuple(
            t for k, name in self._fields for t in _leaves(getattr(self.functions[k], name)))

    def result(self) -> "BatchResult":
        """The solve's result, copied out of the buffers that the next solve
        overwrites."""
        return BatchResult(x=tuple(map(torch.clone, self.x)), h=tuple(map(torch.clone, self.h)),
                           mu=self.mu.clone(), iterations=self.count.clone(),
                           converged=self.done.clone(),
                           primal_residual=self.pbuf[:, :self.hist].clone(),
                           dual_residual=self.dbuf[:, :self.hist].clone())


class BatchedSolver:
    """Solve a batch of same-structure problems.

    ``model`` is the template: its operators (A, C, E couplings) are shared
    across the batch.  Per-instance values are supplied to :meth:`solve` as
    ``overrides``: a dict ``{(block_index, field): batched_array}`` where
    ``field`` is one of the block objective's ``batch_fields`` (e.g.
    ``{(0, "y"): y_batch, (1, "alpha"): lambdas}`` for a λ-path sweep of
    ``LS + L1``); numpy arrays or tensors.  Heavy derived values are made
    once per solve in a prologue (e.g. ``A†y``), so the iteration carries
    only the per-iteration math.

    ``device`` is where the solve runs: ``cuda`` by default (without a CUDA
    device the constructor raises), the host only with ``device="cpu"``.
    ``dtype`` defaults to float64 (complex128 for complex data).

    ``sharding`` (optional): a :func:`~admmsolver_tpu_torch.parallel.mesh.
    batch_sharding` (or ``replicated_sharding``) of a mesh; the device is
    then the mesh's.  Every rank calls the same solves with the same global
    (B, ...) inputs, as a single controller would; each rank takes its lanes
    of them before they move to its device, a batch of B that is not a
    multiple of the world size is padded (padding lanes copy lane 0 and
    start done), and each rank's result holds its real lanes, their global
    indices in ``lane_index``.
    """

    def __init__(self, model: Model, dtype=None, device="cuda", sharding=None) -> None:
        if not isinstance(model, Model):
            raise TypeError(f"expected a Model, got {type(model).__name__}")
        self.sharding = sharding
        self.device = torch.device(device if sharding is None else sharding.mesh.device)
        self.model = model.to(self.device)
        self.plan = ADMMPlan(self.model, self.device)
        # real problems get a real state (see ADMMPlan.is_complex)
        self.dtype = self.plan.default_dtype() if dtype is None else _as_dtype(dtype)
        #: the chunk programs by key (:meth:`_program`), oldest first
        self._programs: Dict[tuple, _ChunkProgram] = {}
        #: the memory of the programs' graphs, made by the first captured solve
        self._pool: Optional[_GraphPool] = None

    # -- parameter binding -------------------------------------------------
    def _bind(self, ov: Dict):
        """Per-instance objective clones from an override dict (batched
        leaves)."""
        if not ov:
            return list(self.model.functions)
        updates: Dict[int, Dict] = {}
        for (k, field), val in ov.items():
            updates.setdefault(k, {})[field] = val
        return [
            f.clone_with(**updates[k]) if k in updates else f
            for k, f in enumerate(self.model.functions)
        ]

    def _validate_overrides(self, overrides: Dict,
                            allow_large_A: bool = False) -> Optional[int]:
        batch = None
        for (k, field), val in overrides.items():
            f = self.model.functions[k]
            if field not in f.batch_fields:
                raise ValueError(
                    f"block {k} ({type(f).__name__}) has no batchable "
                    f"field {field!r}; available: {f.batch_fields}")
            if np.ndim(val) < 1:
                raise ValueError(
                    f"override {(k, field)} must have a leading batch "
                    f"axis, got a scalar; wrap per-instance scalars as a "
                    f"(B,) array")
            if field == "A":
                # Per-instance operators force per-lane dense factors
                # ((B, n, n) inverses).  n <= 128 keeps that factor state
                # small; ``allow_large_A`` (solve_scan) lifts the cap: the
                # scan keeps only one group's factors resident.
                if f.size_x > 128 and not allow_large_A:
                    raise ValueError(
                        f"per-instance A batching is limited to blocks "
                        f"with n <= 128 (block {k} has n={f.size_x}): "
                        "per-lane dense factors at larger n violate the "
                        "HBM budget; use solve_scan (amortized scan over "
                        "instances) or rowshard for large single problems")
                want = getattr(f, "_A").shape
                if tuple(np.shape(val)[1:]) != tuple(want):
                    raise ValueError(
                        f"override {(k, 'A')} must be (B, {want[0]}, "
                        f"{want[1]}) matching the template operator, got "
                        f"{tuple(np.shape(val))}")
            b = np.shape(val)[0]
            if batch is None:
                batch = b
            elif batch != b:
                raise ValueError(
                    f"inconsistent batch sizes: {batch} vs {b} for "
                    f"override {(k, field)}")
        return batch

    def _prologue_overrides(self, ov: Dict) -> Dict:
        """Derived per-instance values, made once per solve.

        ``y`` overrides on (Constrained)LeastSquares blocks are replaced by
        ``Acy`` (= A†y, with the per-instance ``A`` where one is given) so
        the loop never recomputes the reduction.
        """
        out = dict(ov)
        for (k, field) in list(out.keys()):
            f = self.model.functions[k]
            if field == "y" and hasattr(f, "_Ac"):
                y = out.pop((k, field))
                A = out.get((k, "A"))
                out[(k, "Acy")] = (f._Ac.matvec_rows(y) if A is None
                                   else (A.mH @ y[..., None])[..., 0])
        return out

    def _batch(self, overrides: Dict, batch_size: Optional[int]) -> int:
        """The batch size of a solve, from its overrides or ``batch_size``."""
        B = self._validate_overrides(overrides)
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError(
                "batch size is undetermined: pass overrides with a leading "
                "batch axis or batch_size=")
        if batch_size is not None and batch_size != B:
            raise ValueError(f"batch_size={batch_size} != override batch {B}")
        return B

    # -- set-up shared by the solves ---------------------------------------
    def _solve_dtype(self, dtype) -> torch.dtype:
        return self.dtype if dtype is None else _as_dtype(dtype)

    def _config(self, niter, interval_update_mu, update_h, max_mu, fact_incr,
                th_change, relax) -> ADMMConfig:
        if niter <= 0:
            raise ValueError("niter must be positive for batched solves")
        return ADMMConfig(niter=int(niter),
                          interval_update_mu=int(interval_update_mu),
                          update_h=bool(update_h), max_mu=float(max_mu),
                          fact_incr=float(fact_incr),
                          th_change=float(th_change), relax=float(relax))

    def _initial_state(self, B: int, dtype: torch.dtype, x0, h0, mu0, done0):
        """State tensors of a batch of ``B`` on the solver's device."""
        plan, dev = self.plan, self.device

        def blocks(init, sizes, name):
            if init is None:
                # one zero row seen by every lane: the first iteration replaces
                # the state, so a (B, n) array of zeros would only be held by
                # the caller for the whole solve
                return tuple(torch.zeros(n, dtype=dtype, device=dev).expand(B, n)
                             for n in sizes)
            out = tuple(_to_state_dtype(a, dtype, dev) for a in init)
            if [tuple(a.shape) for a in out] != [(B, n) for n in sizes]:
                raise ValueError(f"{name} needs shapes {[(B, n) for n in sizes]}, got "
                                 f"{[tuple(a.shape) for a in out]}")
            return out

        x = blocks(x0, plan.block_sizes, "x0")
        h = blocks(h0, plan.pair_sizes, "h0")
        mu0 = _cast_like(dtype, mu0, dev)
        if mu0.ndim == 1:
            mu0 = mu0[:, None]
        if mu0.ndim == 2 and mu0.shape[0] != B:
            raise ValueError(f"mu0 has {mu0.shape[0]} lanes, expected {B}")
        mu = mu0.expand(B, plan.npairs).clone()
        if done0 is not None:
            done0 = torch.as_tensor(done0, dtype=torch.bool, device=dev)
            if tuple(done0.shape) != (B,):
                raise ValueError(f"done0 has shape {tuple(done0.shape)}, expected ({B},)")
        return x, h, mu, done0

    # -- sharding ------------------------------------------------------------
    def _all_done(self, done: torch.Tensor, failed: Optional[torch.Tensor] = None) -> bool:
        """Whether every lane of the batch is done, in one host read that
        also takes ``failed`` (a factorization's failure flag, raised here).
        On a sharded solver the lanes and flags of every rank: one
        ``all_reduce`` of the count of lanes not done and of the failures,
        which every rank makes at the same point of the schedule."""
        return _flags_read(done, failed, None if self.sharding is None else self.sharding.mesh)

    def _gathered(self, res: BatchResult, B: int) -> BatchResult:
        """All B lanes of a result of this solver, on every rank."""
        if self.sharding is None:
            return res
        return _lanewise(lambda a: self.sharding.gather(a, B), res)

    def _last_lane(self, B: int):
        """A map from a tensor of a result of this solver to its lane B-1,
        on every rank (a broadcast from the rank that holds it)."""
        if self.sharding is None:
            return lambda a: a[B - 1]
        return lambda a: self.sharding.lane(a, B - 1, B)

    def _real_lanes(self, B: int) -> range:
        """The global indices of this rank's lanes below B."""
        lanes = self.sharding.lanes(B)
        return range(lanes.start, max(lanes.start, min(lanes.stop, B)))

    def _local(self, res: BatchResult, B: int) -> BatchResult:
        """This rank's lanes of a result of all B lanes."""
        if self.sharding is None:
            return res
        real = self._real_lanes(B)
        res = _lanewise(lambda a: a[real.start:real.stop], res)
        return dataclasses.replace(res, lane_index=torch.arange(
            real.start, real.stop, device=self.device))

    def _solve_lanes(self, B: int, cfg: ADMMConfig, overrides: Dict, dtype, x0, h0, mu0,
                     done0, tols, record: bool, stride: int, chunked_checks: bool
                     ) -> BatchResult:
        """A batch of B (global inputs) through the schedule; on a sharded
        solver this rank's real lanes of it."""
        n = B
        if self.sharding is not None:
            lanes = self.sharding.lanes(B)
            idx = torch.arange(lanes.start, lanes.stop)
            src = torch.where(idx < B, idx, 0)   # padding lanes copy lane 0

            def take(a):
                a = _asarray(a)
                if a.shape[0] != B:
                    raise ValueError(f"expected a leading batch axis of {B}, got "
                                     f"{tuple(a.shape)}")
                return a.index_select(0, src.to(a.device))

            x0 = None if x0 is None else tuple(map(take, x0))
            h0 = None if h0 is None else tuple(map(take, h0))
            mu0 = _asarray(mu0)
            mu0 = take(mu0) if mu0.ndim else mu0
            # padding lanes start done; every rank knows whether any rank pads
            if done0 is not None:
                done0 = take(torch.as_tensor(done0, dtype=torch.bool))
                done0 = done0 | (idx >= B).to(done0.device)
            elif self.sharding.padded(B) != B:
                done0 = idx >= B
            overrides = {k: take(v) for k, v in overrides.items()}
            n = len(lanes)
        x, h, mu, done0 = self._initial_state(n, dtype, x0, h0, mu0, done0)
        ov = {k: _cast_like(dtype, v, self.device) for k, v in overrides.items()}
        res = self._run(cfg, ov, x, h, mu, tols, done0, record, stride, chunked_checks)
        if self.sharding is None:
            return res
        real = self._real_lanes(B)
        return dataclasses.replace(_trim(res, len(real)), lane_index=torch.arange(
            real.start, real.stop, device=self.device))

    # -- the chunk schedule ------------------------------------------------
    def _run(self, cfg: ADMMConfig, ov: Dict, x, h, mu, tols, done0,
             record: bool, stride: int, chunked_checks: bool,
             read_done0: bool = True) -> BatchResult:
        """One batch through the schedule: prologue, factors and iteration
        0, then chunks of ``interval_update_mu`` iterations (those past
        ``niter`` are not run) through the solve's chunk program
        (:meth:`_program`), each refactoring first, until every lane is
        done.  ``ov`` is already cast and on the device; ``done0`` is a (B,)
        mask or None.  The host reads the done flags, with the failure flag
        of the factorizations, only before a chunk that could be skipped:
        after a chunk that is not the last, and (``read_done0``) once for
        ``done0``; the failure flag alone after the last chunk where the
        model factorizes.  The chunks are replays of captured graphs where
        :meth:`_captures`."""
        plan = self.plan
        interval, niter = cfg.interval_update_mu, cfg.niter
        rtol, atol = tols
        B = mu.shape[0]
        # Strided history: one slot per `stride` iterations (the last
        # in-window value wins).
        hist = (niter + stride - 1) // stride if record else 1
        # No lane's flag can change when neither tolerance can be met: then
        # the host never reads the flags.
        can_finish = rtol > 0 or atol > 0
        all_done = False if done0 is None or not read_done0 else self._all_done(done0)
        # no lane to freeze when none starts done and none can finish
        freeze = can_finish or done0 is not None
        if done0 is None:
            done0 = torch.zeros(B, dtype=torch.bool, device=self.device)
        capture = self._captures(self.model.functions, mu.dtype)
        pool = self._graph_pool(capture)
        key = (dataclasses.replace(cfg, niter=0),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(ov.items())),
               record, chunked_checks, stride, B, x[0].dtype, str(self.device), freeze,
               can_finish, _route_switches())
        nan = lambda: torch.full((B, hist), float("nan"), dtype=torch.float64,
                                 device=self.device)
        program = self._programs.get(key)
        if program is not None:
            program.reserve(hist)
        # A warm program's solve takes its eager working set (the prologue,
        # iteration 0) from the pool: none of it outlives the load.
        with pool.allocating() if pool is not None and program is not None and program.warm \
                else contextlib.nullcontext():
            functions = self._bind(self._prologue_overrides(ov))
            carry = (x, h, mu, None, done0,
                     torch.zeros(B, dtype=torch.int32, device=self.device), nan(), nan())
            if program is None:
                # its buffers before iteration 0's working set, which they
                # would otherwise split and hold on to
                program = self._program(key, cfg, functions, carry, record, stride,
                                        chunked_checks, freeze)
            # iteration 0 (the mu update fires at global_it=0, reference
            # optimizer.py:319-320); the program checks its factorizations
            with deferred_cholesky_checks() as infos:
                carry = plan.iteration(
                    carry[:3] + (plan.compute_factors(mu, functions, batched=True),) + carry[4:],
                    0, 0, cfg, tols, functions, freeze=freeze)
            carry = carry[:3] + (None,) + carry[4:]
            telemetry.check_chunk("BatchedSolver", carry[0], carry[1])
            program.load(functions, carry, tols, infos)
            # the program holds its own copies of the state and the fields
            del carry, infos, functions
        it, unread = 1, program.checks
        while it < niter and not all_done:
            program.run(min(interval, niter - it), capture, pool)
            it += interval
            telemetry.check_chunk("BatchedSolver", program.x, program.h)
            unread = program.checks
            if can_finish and it < niter:
                all_done = self._all_done(program.done, program.failed if unread else None)
                unread = False
        if unread:
            raise_if_not_pd(program.failed)
        return program.result()

    def _captures(self, functions, dtype: torch.dtype) -> bool:
        """Whether a solve's chunks are replays of captured graphs
        (:func:`_captures`)."""
        return _captures(functions, dtype, self.device)

    def _graph_pool(self, create: bool) -> Optional[_GraphPool]:
        """The solver's graph pool, made by its first captured solve."""
        if self._pool is None and create:
            self._pool = _GraphPool(self.device)
        return self._pool

    def _program(self, key, cfg, functions, carry, record, stride, chunked_checks,
                 freeze) -> _ChunkProgram:
        """A new chunk program for ``key``; at most :data:`PROGRAM_CACHE_SIZE`
        of them, the oldest dropped first.  The key: the JAX package's
        ``(cfg, ov_keys, record, chunked_checks, record_stride)``
        (``batch.py:251-264``) without ``niter`` (the host loop counts the
        chunks, and a longer history takes new buffers: :meth:`_ChunkProgram.
        reserve`), with the overrides' shapes and dtypes, what the schedule
        branches on (B, dtype, device, freeze, whether a lane can finish)
        and the route switches a graph keeps (:func:`_route_switches`); the
        tolerances are values of the program."""
        return _keep(self._programs, key, _ChunkProgram(
            self.plan, cfg, self.model.functions, functions, carry, record, stride,
            chunked_checks, freeze))

    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              x0: Optional[Sequence] = None,
              h0: Optional[Sequence] = None,
              mu0=1.0,
              niter: int = 10000,
              interval_update_mu: int = 100,
              update_h: bool = True,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              record_residuals: Union[bool, int] = True,
              dtype=None,
              chunked_checks: bool = False,
              done0=None,
              recipe: str = "auto",
              relax: float = 1.0) -> BatchResult:
        """Solve the batch.  Reference-default knobs
        (``optimizer.py:302-309,277,125``); ``atol`` adds an absolute
        primal+dual residual stop (0 = off); ``fact_incr``/``th_change``
        tune the penalty adaptation as the reference's ``update_mu``
        does; ``dtype`` overrides the solver's state dtype for this call
        (mixed-precision phases); ``x0``/``h0``/``mu0`` (scalar, (B,) or
        (B, npairs)) warm-start the state; ``chunked_checks=True``
        evaluates residuals/convergence/penalty adaptation only on
        penalty-boundary iterations (throughput mode — histories have one
        sample per ``interval_update_mu`` iterations and lanes may overrun
        their convergence point by up to one interval; the default
        preserves exact per-iteration reference semantics).

        ``record_residuals``: True = per-iteration histories ((B, niter)
        float64 buffers); an int ``s`` records one sample per ``s``
        iterations ((B, ceil(niter/s)) buffers, slot ``min(it // s,
        hist - 1)``); False = none.  ``done0``: optional (B,) bool mask of
        lanes to freeze from the start; frozen lanes keep their state, count
        no iterations and do not hold up the exit.

        ``recipe``: ``"plain"`` is the single-phase solve (exact reference
        trajectory semantics); ``"mixed"`` routes through
        :meth:`solve_mixed` with 3/4 of the budget in float32 and needs
        ``niter >= 2``; ``"auto"`` (default) is plain: when the mixed recipe
        pays on this hardware has not been measured."""
        if recipe not in ("auto", "plain", "mixed"):
            raise ValueError(f"recipe must be auto|plain|mixed, {recipe!r}")
        if recipe == "mixed":
            if niter < 2:
                raise ValueError(
                    "recipe='mixed' splits niter into two positive phases "
                    f"and needs niter >= 2, got {niter}")
            nl = 3 * niter // 4
            return self.solve_mixed(
                overrides, niter_low=nl, niter=niter - nl,
                # fixed-iteration runs (rtol=atol=0) burn the full f32
                # budget; convergence runs let phase 1 exit at plateau
                low_rtol=(0.0 if (rtol == 0.0 and atol == 0.0) else 1e-6),
                batch_size=batch_size, x0=x0, h0=h0, mu0=mu0,
                interval_update_mu=interval_update_mu, update_h=update_h,
                rtol=rtol, atol=atol, fact_incr=fact_incr,
                th_change=th_change, max_mu=max_mu,
                record_residuals=record_residuals,
                chunked_checks=chunked_checks, done0=done0, relax=relax,
                dtype=dtype)
        dtype = self._solve_dtype(dtype)
        overrides = dict(overrides or {})
        B = self._batch(overrides, batch_size)
        cfg = self._config(niter, interval_update_mu, update_h, max_mu,
                           fact_incr, th_change, relax)
        record, stride = _parse_record_residuals(record_residuals)
        return self._solve_lanes(B, cfg, overrides, dtype, x0, h0, mu0, done0,
                                 (rtol, atol), record, stride, bool(chunked_checks))

    def solve_path(self,
                   field: Tuple[int, str],
                   values,
                   overrides: Optional[Dict] = None,
                   group_size: Optional[int] = None,
                   fused: bool = True,
                   **kw) -> BatchResult:
        """Warm-started regularization-path continuation.

        Splits ``values`` (e.g. a descending λ grid) into groups of
        ``group_size``; each group solves as one batch, warm-started from
        the previous group's last lane (the nearest value's state).  For
        dense paths this cuts iteration counts several-fold versus cold
        starts.  Returns concatenated per-value results in input order;
        further ``overrides`` are per value (length ``len(values)``).

        ``fused=True`` (default) pads the last group by repeating the final
        value, so that every group has ``group_size`` lanes, and trims the
        padding from the result, as the JAX package's one-program form
        does; ``fused=False`` solves the shorter last group as it is.  Both
        give the same lanes.
        """
        values = np.asarray(values)
        n = values.shape[0]
        if group_size is None:
            group_size = n
        gs = int(group_size)
        if gs < n:
            # Warm starts broadcast the previous group's LAST lane state —
            # only sensible when consecutive values are nearest neighbors.
            d = np.diff(values.astype(np.float64))
            if not (np.all(d <= 0) or np.all(d >= 0)):
                raise ValueError(
                    "solve_path warm-starting requires a monotone `values` "
                    "grid (each group is seeded from the previous group's "
                    "last solution); sort the values or pass "
                    "group_size=len(values)")
        ov_all = {k: _asarray(v) for k, v in dict(overrides or {}).items()}
        ov_all[field] = _asarray(values)
        for (k, f_), v in ov_all.items():
            if v.shape[0] != n:
                raise ValueError(
                    f"solve_path override {(k, f_)} must be per-value "
                    f"(length {n}), got leading axis {v.shape[0]}")
        pad_n = (-n) % gs if fused and gs < n else 0
        ov_all = {k: _pad_last(v, pad_n) for k, v in ov_all.items()}
        mu0 = kw.pop("mu0", 1.0)
        x0, h0 = kw.pop("x0", None), kw.pop("h0", None)
        parts = []
        for s in range(0, n + pad_n, gs):
            ov = {k: v[s:s + gs] for k, v in ov_all.items()}
            prev = self.solve(ov, x0=x0, h0=h0, mu0=mu0, **kw)
            parts.append(_shift(prev, s))
            # warm start every lane of the next group from this group's
            # last (nearest) solution, which one rank of a sharded solver holds
            nxt = min(gs, n + pad_n - s - gs)
            if nxt <= 0:
                break
            lane = self._last_lane(ov[field].shape[0])
            take = lambda a: lane(a)[None].expand((nxt,) + tuple(a.shape[1:]))
            x0, h0 = tuple(map(take, prev.x)), tuple(map(take, prev.h))
            mu0 = take(prev.mu)
        return _trim(_concat(parts), n)

    def solve_scan(self,
                   overrides: Dict,
                   group_size: int = 1,
                   x0: Optional[Sequence] = None,
                   h0: Optional[Sequence] = None,
                   mu0=1.0,
                   niter: int = 10000,
                   interval_update_mu: int = 100,
                   update_h: bool = True,
                   rtol: float = 1e-12,
                   atol: float = 0.0,
                   fact_incr: float = 2.0,
                   th_change: float = 10.0,
                   max_mu: float = 1e3,
                   record_residuals: Union[bool, int] = False,
                   chunked_checks: bool = False,
                   relax: float = 1.0) -> BatchResult:
        """Sequential solve over groups of ``group_size`` instances.

        The fallback for batches of LARGE heterogeneous problems (per-
        instance ``(k, 'A')`` operators with n > 128): :meth:`solve` keeps
        every lane's dense factor resident ((B, n, n), which the n <= 128
        cap guards).  Here only ``group_size`` instances' factors exist at
        a time.  Reference analogue: one ``SimpleOptimizer`` per problem
        (``optimizer.py:121-152``).  The last group holds the instances that
        are left.

        Wall-clock is sequential over ``B / group_size`` groups — use
        :meth:`solve` when the factor state fits.  ``record_residuals``
        defaults to False; the other knobs are those of :meth:`solve`
        (the recipe is plain, the dtype the solver's).
        """
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides, allow_large_A=True)
        if B is None:
            raise ValueError("solve_scan needs overrides with a leading "
                             "batch axis")
        g = int(group_size)
        cfg = self._config(niter, interval_update_mu, update_h, max_mu,
                           fact_incr, th_change, relax)
        record, stride = _parse_record_residuals(record_residuals)
        tols = (rtol, atol)
        mu0 = _asarray(mu0)
        lead = [np.shape(a)[0] for a in (*(x0 or ()), *(h0 or ()), *([mu0] if mu0.ndim else []))]
        if any(b != B for b in lead):
            raise ValueError(f"x0, h0 and mu0 need a leading batch axis of {B}, got {lead}")
        grp = lambda a, s: None if a is None else tuple(v[s:s + g] for v in a)
        return _concat([_shift(self._solve_lanes(
            min(g, B - s), cfg, {k: v[s:s + g] for k, v in overrides.items()},
            self.dtype, grp(x0, s), grp(h0, s), mu0[s:s + g] if mu0.ndim else mu0,
            None, tols, record, stride, bool(chunked_checks)), s)
            for s in range(0, B, g)])

    def solve_resumable(self,
                        path: str,
                        overrides: Optional[Dict] = None,
                        checkpoint_every: int = 1000,
                        niter: int = 10000,
                        mu0=1.0,
                        **kw) -> BatchResult:
        """Preemption-tolerant solve: checkpoint every ``checkpoint_every``
        iterations, resume from ``path`` if it exists.

        The reference's only resume mechanism is a manual ``x0`` warm start
        (``optimizer.py:146-149``); this drives the same warm start segment
        by segment and persists the full carry (primal, dual, penalties,
        per-lane iteration counts, convergence flags) through
        :mod:`admmsolver_tpu_torch.utils.checkpoint` after each segment, in
        the layout the JAX package reads and writes.  Killing the process
        loses at most one segment.  The loop stops once every lane has
        converged; a checkpoint that already covers ``niter`` is returned
        without another solve.

        Each segment starts the ``interval_update_mu`` clock afresh (as a
        fresh solve from a warm start does), so pick ``checkpoint_every`` as
        a multiple of ``interval_update_mu`` to keep the uninterrupted
        schedule.
        """
        import os

        from ..utils.checkpoint import load_batch_result, save_batch_result

        # segments continue exact state; a mixed recipe's f32 phase would
        # truncate a warm-started carry mid-run
        kw.setdefault("recipe", "plain")
        B = self._batch(dict(overrides or {}), kw.get("batch_size"))
        x0 = h0 = None
        done_iters = 0
        total = None
        if os.path.exists(path):
            ckpt = load_batch_result(path, device=self.device)
            x0, h0, mu0 = ckpt.x, ckpt.h, ckpt.mu
            total = ckpt.iterations
            done_iters = int(total.max())
        res = None
        while done_iters < niter:
            n = min(int(checkpoint_every), niter - done_iters)
            # a sharded solver's segments hand on the state of all lanes
            res = self._gathered(self.solve(overrides, x0=x0, h0=h0, mu0=mu0, niter=n, **kw),
                                 B)
            x0, h0, mu0 = res.x, res.h, res.mu
            done_iters += n
            total = res.iterations if total is None else total + res.iterations
            res = dataclasses.replace(res, iterations=total)
            if self.sharding is None:
                save_batch_result(path, res)
            else:
                # rank 0 writes the one file, and no rank goes on before it is
                # written
                if self.sharding.mesh.rank == 0:
                    save_batch_result(path, res)
                self.sharding.mesh.barrier()
            if bool(res.converged.all()):
                break
        if res is None:
            # the checkpoint already covered the full budget
            res = load_batch_result(path, device=self.device)
        return self._local(res, B)

    def solve_mixed(self,
                    overrides: Optional[Dict] = None,
                    niter_low: int = 2000,
                    niter: int = 10000,
                    low_dtype="float32",
                    low_rtol: float = 1e-6,
                    fused: bool = False,
                    dtype=None,
                    **kw) -> BatchResult:
        """Two-phase mixed-precision solve.

        Phase 1 iterates in ``low_dtype`` until the relative residual
        change plateaus at ``low_rtol`` or ``niter_low`` is reached; phase
        2 continues the SAME primal/dual/penalty state at full precision
        (``dtype`` when given, else the solver's) to the requested
        tolerance.  ADMM is self-correcting — the dual state carries the
        low-precision phase's progress exactly — so the hand-off costs
        nothing in final accuracy.  Iteration counts are summed and the
        histories concatenated; the other knobs go to both phases.

        ``fused`` is accepted for the JAX package's callers: there it
        selects a second program, here both settings run the same two
        calls and give the same result.  As there, ``fused=True`` polishes
        at the solver dtype only.
        """
        kw.pop("recipe", None)  # the phases ARE the recipe
        if fused and dtype is not None and _as_dtype(dtype) != self.dtype:
            raise ValueError(
                "the fused mixed solve always polishes at the "
                "solver dtype; construct the solver with the "
                "desired full precision or use fused=False")
        if niter_low <= 0 or niter <= 0:
            raise ValueError("phase iteration budgets must be positive")
        B = self._batch(dict(overrides or {}), kw.get("batch_size"))
        p1 = self.solve(overrides, niter=niter_low, dtype=low_dtype,
                        rtol=low_rtol, recipe="plain",
                        **{k: v for k, v in kw.items()
                           if k not in ("rtol", "atol")})
        # phase 2 continues phase 1's state at the FULL precision — the
        # caller's explicit dtype when given, else the solver dtype.  Lanes
        # that phase 1 finished start anew: only the caller's done0 skips
        # the polish.
        # the polish of a sharded solver starts from the state of all lanes
        s1 = self._gathered(p1, B)
        p2 = self.solve(overrides, x0=s1.x, h0=s1.h, mu0=s1.mu,
                        niter=niter, recipe="plain", dtype=dtype,
                        **{k: v for k, v in kw.items()
                           if k not in ("mu0", "x0", "h0")})
        return BatchResult(
            x=p2.x, h=p2.h, mu=p2.mu,
            iterations=p1.iterations + p2.iterations,
            converged=p2.converged,
            primal_residual=torch.cat(
                [p1.primal_residual, p2.primal_residual], dim=1),
            dual_residual=torch.cat(
                [p1.dual_residual, p2.dual_residual], dim=1),
            lane_index=p2.lane_index)
