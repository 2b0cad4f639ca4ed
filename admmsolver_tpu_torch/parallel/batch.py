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

A solve runs through a static program of one group (:class:`_FedProgram`,
the JAX package's one compiled program of a solve, ``batch.py:251-470``):
fixed buffers for the state and the solve's inputs, an entry step
(prologue, binding, factors, iteration 0) and the chunks' work over them,
and on a CUDA device one captured CUDA graph for the entry and one a chunk
length, each replayed once a solve or a chunk.  Every program of the port
runs its steps through the one schedule of :class:`_GraphProgram`, and
every solver keeps its programs in a :class:`_ProgramCache` like the JAX
package's (:data:`PROGRAM_CACHE_SIZE`, the oldest dropped first), their
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
import weakref
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


def _history_length(niter: int, record: bool, stride: int) -> int:
    """The columns of a solve's histories: one a ``stride`` iterations (the
    last in-window value wins), one without ``record``."""
    return (niter + stride - 1) // stride if record else 1


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
    """The kernels' launch counters (:func:`~admmsolver_tpu_torch.ops.
    kernels.launch_counters`)."""
    from ..ops import kernels

    return kernels.launch_counters()


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


def _storage(t: torch.Tensor) -> int:
    """The address of the memory ``t`` views."""
    return t.untyped_storage().data_ptr()


def _each_once(tensors) -> Tuple[torch.Tensor, ...]:
    """``tensors`` with each memory once: the first tensor that views it."""
    seen, out = set(), []
    for t in tensors:
        if _storage(t) not in seen:
            seen.add(_storage(t))
            out.append(t)
    return tuple(out)


def _fresh(v, keep=frozenset()):
    """``v`` with every tensor of it a new contiguous copy, but those that
    view the memory at an address in ``keep``."""
    if isinstance(v, torch.Tensor):
        return v if _storage(v) in keep else v.clone(memory_format=torch.contiguous_format)
    if isinstance(v, LaneOperators):
        out = copy.copy(v)
        out.data = _fresh(v.data, keep)
        return out
    if isinstance(v, (tuple, list)):
        return type(v)(_fresh(a, keep) for a in v)
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


def _flags_read(done: torch.Tensor, failed: Optional[torch.Tensor] = None,
                mesh=None) -> bool:
    """Whether every lane is done, in one host read that also takes
    ``failed`` (a factorization's failure flag, raised here); over a
    ``mesh``, the lanes and flags of every rank by one ``all_reduce`` of the
    count of lanes not done and of the failures."""
    with telemetry.span("admm.flags_read"):
        telemetry.count("flag_reads")
        flags = torch.stack([(~done).sum(), (done.new_zeros(()) if failed is None
                                             else failed).to(torch.int64)])
        if mesh is not None:
            flags = mesh.all_reduce(flags)
        not_done, failures = flags.tolist()
    raise_if_not_pd(failures > 0)
    return not_done == 0


class _ProgramCache(dict):
    """A solver's programs by key, oldest first: at most
    :data:`PROGRAM_CACHE_SIZE`, the oldest dropped at a miss (the JAX package's
    ``_compiled_cache``, ``batch.py:141,261-262``), each key with the route
    switches a graph keeps (:func:`_route_switches`).  It decides whether a
    solve captures (:meth:`captures`) and holds the graph pool that every
    program of the solver captures into (:meth:`graph_pool`)."""

    def __init__(self, device) -> None:
        super().__init__()
        self.device = torch.device(device)
        #: the memory of the programs' graphs, made by the first captured solve
        self.pool: Optional[_GraphPool] = None

    def program(self, key: tuple, build):
        """The program of ``key``, which ``build()`` makes on a miss."""
        key = key + (_route_switches(),)
        program = self.get(key)
        if program is None:
            with telemetry.span("admm.build"):
                telemetry.count("program_builds")
                program = build()
            if len(self) >= PROGRAM_CACHE_SIZE:
                self.pop(next(iter(self)))
            self[key] = program
        return program

    def captures(self, functions=(), dtype=None, allowed: bool = True) -> bool:
        """Whether a solve replays its steps as captured graphs: with
        :data:`CAPTURE_CHUNKS` and ``allowed``, on a CUDA device, where every
        objective of ``functions`` declares its steps capturable (a state of
        ``dtype``)."""
        return CAPTURE_CHUNKS and allowed and self.device.type == "cuda" and all(
            f.capturable(_real_dtype(dtype), self.device) for f in functions)

    def graph_pool(self, capture: bool) -> Optional[_GraphPool]:
        """The graph pool, made by the first solve that captures."""
        if capture and self.pool is None:
            self.pool = _GraphPool(self.device)
        return self.pool


class _GraphProgram:
    """What every static program shares: its steps (:meth:`_chunk`, by a key
    that names a step's length and kind), which read and write only the
    program's buffers, run directly or, on a CUDA device, captured once a
    key into a graph of the solver's pool and replayed; the schedule of a
    solve's steps with the host's reads of the done flags between them
    (:meth:`run_schedule`); the failure flag of the steps' factorizations
    (:meth:`factorizing`); and the residual histories (:attr:`pbuf`,
    :attr:`dbuf`).  A program that holds one of these rather than deriving
    from it passes its step function as ``chunk``.

    On a CUDA device a captured solve runs the program's first step
    eagerly (libraries load, caches fill), then captures each key once
    into a graph of the solver's pool (:class:`_GraphPool`) and replays it
    once a step; a replay adds the kernel launches and the telemetry
    counts (:func:`~admmsolver_tpu_torch.utils.telemetry.capturing`) its
    capture counted.
    Otherwise (the CPU, :data:`CAPTURE_CHUNKS` off, a route a graph cannot
    hold) the step runs directly, from the pool where there is one and the
    program is warm.  A step that fails to capture raises.

    Inside :func:`~admmsolver_tpu_torch.utils.telemetry.tracing` a key's
    graph is another one, captured with device marks in it
    (``chunk.start``, ``chunk.end`` and what the step marks:
    :class:`~admmsolver_tpu_torch.utils.telemetry.Marks`); elsewhere the
    graphs hold no event node."""

    #: whether the host may read the done flags after a solve's first step
    #: (a fed program's entry is followed by its first chunk unread)
    reads_after_entry = True

    def __init__(self, done: torch.Tensor, what: str, checked, hist_shape, hist_dtype,
                 hist_axis: int = 0, chunk=None) -> None:
        self.warm = False
        #: chunk key -> (graph, kernel launches and telemetry counts of one
        #: replay, taken at its capture)
        self.graphs: Dict = {}
        #: chunk key -> (graph, launches, counts, marks): the graphs with marks
        self.marked: Dict = {}
        #: host seconds of each key's last capture
        self.capture_s: Dict = {}
        self._chunk_fn = chunk
        #: the lanes' done flags; the solver that a check of the state between
        #: steps names, and the state it checks (:func:`~admmsolver_tpu_torch.
        #: utils.telemetry.check_chunk`)
        self.done, self.what, self.checked = done, what, tuple(checked)
        #: whether a step factorizes, and whether a factorization failed
        #: (:meth:`factorizing`)
        self.checks = False
        self.failed = torch.zeros((), dtype=torch.bool, device=done.device)
        #: the axis of the histories that their rows run along (:meth:`reserve`)
        self.hist_axis = hist_axis
        self.pbuf, self.dbuf = (torch.full(hist_shape, float("nan"), dtype=hist_dtype,
                                           device=done.device) for _ in range(2))

    def _chunk(self, key) -> None:
        self._chunk_fn(key)

    @staticmethod
    def schedule(niter: int, interval: int):
        """The chunks of a solve as (iterations, penalty update): iteration
        0, the full chunks of ``interval``, the remainder (reference
        ``optimizer.py:319-320``: the update fires after iteration 0 and
        after every full chunk, never after the remainder)."""
        if niter < 1 or interval < 1:
            raise ValueError(f"niter and interval_update_mu must be >= 1, got {niter}, "
                             f"{interval}")
        nfull, nrem = divmod(niter - 1, interval)
        return [(1, True)] + [(interval, True)] * nfull + ([(nrem, False)] if nrem else [])

    def run_schedule(self, keys, capture: bool, pool: Optional[_GraphPool], can_finish: bool,
                     read_flags=None, all_done: bool = False) -> bool:
        """A solve's steps ``keys`` in order (:meth:`_run_chunk`): the first,
        its entry (a fed program's ``"entry"``, iteration 0 of the others),
        then the others while a lane is not done (``all_done``: every lane
        starts done).  Where a lane can finish, the host reads the done flags
        (:meth:`flags_read`) after each step that is not the last, but not
        after the entry where :attr:`reads_after_entry` is off.  Returns
        whether the failure flag is left unread, for the caller to read."""
        unread = False
        for k, key in enumerate(keys):
            if k and all_done:
                break
            self._run_chunk(key, capture, pool)
            telemetry.check_chunk(self.what, self.checked)
            unread = self.checks
            if can_finish and k + 1 < len(keys) and (k or self.reads_after_entry):
                all_done, unread = self.flags_read(read_flags), False
        return unread

    def flags_read(self, read_flags=None) -> bool:
        """Whether every lane is done, in one host read ``read_flags(done,
        failed or None)`` (None: :func:`_flags_read`) that also takes the
        failure flag where a step factorizes."""
        return (read_flags or _flags_read)(self.done, self.failed if self.checks else None)

    @contextlib.contextmanager
    def factorizing(self):
        """A step's factorizations, their Cholesky infos kept on the device
        (:func:`~admmsolver_tpu_torch.models.objectivefunc.
        deferred_cholesky_checks`) and gathered in :attr:`failed`."""
        with deferred_cholesky_checks() as infos:
            yield
        if infos:
            self.checks = True
            self.failed.logical_or_(any_not_pd(infos))

    def reserve(self, n: int) -> None:
        """Histories of at least ``n`` rows along :attr:`hist_axis`: longer
        ones than the program holds are new buffers, and so need new
        graphs."""
        shape = list(self.pbuf.shape)
        if n > shape[self.hist_axis]:
            shape[self.hist_axis] = n
            self.pbuf, self.dbuf = (self.pbuf.new_full(shape, float("nan")) for _ in range(2))
            self.drop_graphs()

    def clear_histories(self) -> None:
        """NaN in every row of the histories: rows no iteration writes."""
        self.pbuf.fill_(float("nan"))
        self.dbuf.fill_(float("nan"))

    def drop_graphs(self, *keys) -> None:
        """Forget the graphs of ``keys`` (of every key without), marked or
        not: they read or write buffers that changed."""
        for table in (self.graphs, self.marked):
            for key in keys or list(table):
                table.pop(key, None)

    def _run_chunk(self, key, capture: bool, pool: Optional[_GraphPool]) -> None:
        """One chunk: with ``capture`` (and ``pool``) a replay of its graph,
        once the program is warm; else the chunk itself, from ``pool``
        where there is one and the program is warm."""
        with telemetry.span("admm.chunk", key=key):
            if not (capture and self.warm):
                with telemetry.span("admm.eager"):
                    telemetry.count("eager_chunks")
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
            marked = telemetry.marking()
            table = self.marked if marked else self.graphs
            if key not in table:
                self._capture(key, pool)
            graph, launches, counts = table[key][:3]
            if marked:
                table[key][3].begin()
            with telemetry.span("admm.replay"):
                telemetry.count("replays")
                graph.replay()
            for kernel, count in zip(_counted_kernels(), launches):
                kernel.launches += count
            for name, n in counts.items():
                telemetry.count(name, n)

    def _capture(self, key, pool: _GraphPool) -> None:
        """Capture the chunk of ``key`` (nothing runs) into a graph of
        ``pool``, with device marks inside :func:`~admmsolver_tpu_torch.
        utils.telemetry.tracing`; a chunk that a graph cannot hold raises."""
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
        marks = (telemetry.Marks("chunks_timed", external=True, key=key)
                 if telemetry.marking() else None)
        counts: Dict[str, float] = {}
        t0 = time.perf_counter()
        try:
            with telemetry.span("admm.capture", key=key), torch.cuda.device(pool.device), \
                    torch.cuda.graph(graph, pool=pool.mempool.id, stream=pool.stream), \
                    telemetry.capturing(counts):
                if marks is None:
                    self._chunk(key)
                else:
                    marks.record("chunk.start")
                    with telemetry.collecting(marks):
                        self._chunk(key)
                    marks.record("chunk.end")
        except BaseException:
            pool.end_failed_capture()
            raise
        finally:
            launches = [kernel.launches - b for kernel, b in zip(kernels, before)]
            for kernel, b in zip(kernels, before):
                kernel.launches = b
            # a capture that fails leaves its stream current
            torch.cuda.set_stream(current)
        seconds = self.capture_s[key] = time.perf_counter() - t0
        telemetry.count("captures")
        telemetry.count("capture_s", seconds)
        pool.bytes += torch.cuda.memory_reserved(pool.device) - reserved
        if marks is None:
            self.graphs[key] = (graph, launches, counts)
        else:
            self.marked[key] = (graph, launches, counts, marks)


@dataclasses.dataclass
class _Feed:
    """Where a fed chunk program (:class:`_FedProgram`) takes each group's
    inputs and puts its outputs, every tensor on the card.

    ``ov``: the overrides stacked (G, gs, ...) at the solver's dtype, or
    with ``slots`` the (gs, ...) overrides of a plain solve's one group,
    which the solve loads (a slot the prologue passes on unchanged is the
    field buffer that holds it, and one it derives a field of its shape
    from, such as y for A†y, shares that field's buffer); ``seed``: the
    state a group starts from, x blocks, h blocks and mu, as (G, gs, ...)
    stacks where ``stacked``, else (gs, ...) tensors of any dtype (another
    phase's buffers: the entry casts them), or None: the program's own
    state buffers (a plain solve loads them; a wave carries them); ``done``:
    the flags a group starts from (None: all False); ``out``: the (G, gs,
    ...) stacks of x, h, mu, done, count and both histories that the exit
    writes (None: no exit); ``warm``: whether the exit seeds the next group
    from its last lane (the λ-path)."""

    ov: Dict
    seed: Optional[Tuple[torch.Tensor, ...]]
    stacked: bool = False
    done: Optional[torch.Tensor] = None
    out: Optional[Tuple[torch.Tensor, ...]] = None
    warm: bool = False
    slots: bool = False


class _FedProgram(_GraphProgram):
    """A static program of one cache key whose solves begin on the card: the
    JAX package's compiled ``_build`` and ``run`` of one batch (``batch.py:
    345-470``, :meth:`BatchedSolver._run`) and its group body as the
    composites scan or chain it (``batch.py:266-343``, ``:895-921``).

    It owns the buffers its steps read and write: the state x, h, mu, done,
    count and the histories, the per-solve fields of the bound objectives
    (overrides and what the prologue derives from them: new buffers but
    those that view a slot of the feed), the tolerances and the first
    global iteration of a chunk.  Its steps, keys of one
    :class:`_GraphProgram`:

    * ``"entry"`` takes the group's overrides (:meth:`_overrides`: group
      ``group``, a device index, of the feed's stacks, or a plain solve's
      slots), runs the prologue and binds them into the program's field
      buffers, seeds the state from the feed, resets the histories, and
      runs the factors and iteration 0 from the done flags of
      :meth:`_done0`;
    * a chunk (key: its length, :meth:`_iterate`) refactors from mu, runs
      its iterations and copies the results into the buffers; the factors
      live only inside it, so that old and new factors never coexist.  The
      penalty update fires at the chunk's last position only in a full
      chunk, so one step of each length serves every chunk of a solve; the
      history slot of each iteration is computed on the device;
    * ``"exit"`` copies x, h, mu, done, count and the histories into rows
      ``group * gs`` of the feed's output stacks, seeds the next group of a
      path from this group's last lane, and advances ``group``.

    So the host reads nothing between groups; :meth:`run_group` reads the
    done flags only before a chunk where a lane can finish.  The Cholesky
    factorizations keep their info on the device (:meth:`factorizing`):
    the failure flag gathers over every group and is read once after the
    last (:meth:`_Composite.run`), or after a plain solve's last chunk."""

    reads_after_entry = False

    def __init__(self, solver: "BatchedSolver", cfg: ADMMConfig, feed: _Feed, functions, B: int,
                 dtype: torch.dtype, tols, record: bool, stride: int, chunked_checks: bool,
                 freeze: Optional[bool] = None) -> None:
        rtol, atol = tols
        self.can_finish = rtol > 0 or atol > 0
        self.freeze = (self.can_finish or feed.done is not None) if freeze is None else freeze
        self.plan, self.cfg, self.chunked_checks = solver.plan, cfg, chunked_checks
        # the fields a solve supplies: those its bound objectives do not share
        # with the template
        self._fields = [(k, name) for k, (f, t) in enumerate(zip(functions, solver.model.functions))
                        if f is not t for name, v in vars(f).items()
                        if v is not vars(t).get(name) and _leaves(v)]
        self.functions = list(functions)
        for k in {k for k, _ in self._fields}:
            self.functions[k] = copy.copy(functions[k])
        slots = {_storage(v) for v in feed.ov.values()} if feed.slots else frozenset()
        for k, name in self._fields:
            setattr(self.functions[k], name, _fresh(getattr(functions[k], name), slots))
        dev = solver.device
        zeros = lambda *shape, dt=dtype: torch.zeros((B,) + shape, dtype=dt, device=dev)
        self.x = tuple(zeros(n) for n in self.plan.block_sizes)
        self.h = tuple(zeros(n) for n in self.plan.pair_sizes)
        self.mu, self.count = zeros(self.plan.npairs, dt=_real_dtype(dtype)), zeros(dt=torch.int32)
        self.hist = _history_length(cfg.niter, record, stride)
        super().__init__(zeros(dt=torch.bool), "BatchedSolver", self.x + self.h, (B, self.hist),
                         torch.float64, hist_axis=1)
        self.tols = (self.mu.new_zeros(()), self.mu.new_zeros(()))
        self.record, self.stride = record, stride
        # the first global iteration of a chunk, and a chunk's offsets
        self.it = torch.ones(1, dtype=torch.long, device=dev)
        self.steps = torch.arange(cfg.interval_update_mu, device=dev)
        # the solver holds the program
        self._bound = weakref.WeakMethod(solver._bound)
        self.feed = feed
        self.group = torch.zeros(1, dtype=torch.long, device=dev)
        if feed.slots:
            self._share_slots(slots)

    def _field_buffers(self) -> List[torch.Tensor]:
        """The tensors of the fields a solve supplies."""
        return [t for k, name in self._fields for t in _leaves(getattr(self.functions[k], name))]

    def _share_slots(self, slots) -> None:
        """Each slot that no field holds (the prologue derives fields from
        it) takes the memory of a field buffer of its shape and dtype where
        there is one: the entry has derived every field before it writes
        one, and nothing reads the slot after."""
        fields = self._field_buffers()
        held = {_storage(t) for t in fields}
        free = [t for t in fields if _storage(t) not in slots]
        for k, v in self.feed.ov.items():
            if _storage(v) in held:
                continue
            for t in free:
                if t.shape == v.shape and t.dtype == v.dtype and t.is_contiguous():
                    self.feed.ov[k] = t
                    free.remove(t)
                    break

    @telemetry.spanned("admm.load")
    def load(self, tols, stacks: Optional[Dict] = None, seed=(), done=None,
             hist: Optional[int] = None) -> None:
        """A solve's tolerances and (where given) its stacked overrides and
        seeds into the feed; its first group is group 0.  A plain solve
        (``slots``) loads its overrides into the slots, its initial state
        into the program's state buffers, its ``done0`` (None: all False)
        and the length of its histories."""
        feed = self.feed
        # a program's stacks may hold more groups than this solve's
        for k, v in (stacks or {}).items():
            feed.ov[k][:v.shape[0]].copy_(v)
        for d, t in zip(self.x + self.h + (self.mu,) if feed.seed is None else feed.seed, seed):
            d[:t.shape[0]].copy_(t)
        if feed.slots:
            if done is None:
                feed.done.zero_()
            else:
                feed.done.copy_(done)
            self.hist = hist
        for d, t in zip(self.tols, tols):
            d.fill_(t)
        self.group.zero_()
        self.failed.zero_()

    def _chunk(self, key) -> None:
        if key == "entry":
            self._entry()
        elif key == "exit":
            self._exit()
        else:
            self._iterate(key)

    def _overrides(self) -> Dict:
        """The overrides of the entry's group, in the state's dtype."""
        if self.feed.slots:
            return dict(self.feed.ov)
        return {k: _cast_like(self.x[0].dtype, v.index_select(0, self.group)[0])
                for k, v in self.feed.ov.items()}

    def _done0(self) -> torch.Tensor:
        """The done flags the entry's group starts from."""
        return torch.zeros_like(self.done) if self.feed.done is None else self.feed.done

    def _entry(self) -> None:
        feed, plan = self.feed, self.plan
        functions = self._bound()(self._overrides())
        for k, name in self._fields:
            for d, t in zip(_leaves(getattr(self.functions[k], name)),
                            _leaves(getattr(functions[k], name))):
                # a slot bound as it is needs no copy
                if (d.data_ptr(), d.stride()) != (t.data_ptr(), t.stride()):
                    d.copy_(t)
        state = self.x + self.h + (self.mu,)
        if feed.seed is None:
            seed = list(state)
        else:
            # the seeds in this program's dtypes: a phase hand-off promotes here
            seed = [(a.index_select(0, self.group)[0] if feed.stacked else a).to(b.dtype)
                    for a, b in zip(feed.seed, state)]
        nx, mu = len(self.x), seed.pop()
        self.clear_histories()
        # iteration 0 (the mu update fires at global_it=0, reference
        # optimizer.py:319-320)
        with self.factorizing():
            carry = plan.iteration(
                (tuple(seed[:nx]), tuple(seed[nx:]), mu,
                 plan.compute_factors(mu, functions, batched=True), self._done0(),
                 torch.zeros_like(self.count), self.pbuf, self.dbuf),
                0, 0, self.cfg, self.tols, functions, freeze=self.freeze)
        x, h, mu, _, done, count = carry[:6]
        for d, t in zip(self.x + self.h + (self.mu, self.done, self.count),
                        x + h + (mu, done, count)):
            d.copy_(t)
        self.it.fill_(1)

    def _iterate(self, n: int) -> None:
        """A chunk: refactor from mu, then ``n`` iterations, their results
        copied into the buffers.  The penalty schedule repeats every chunk,
        so the iterations take the first chunk's global indices 1..n."""
        plan, cfg = self.plan, self.cfg
        with self.factorizing():
            factors = plan.compute_factors(self.mu, self.functions, batched=True)
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

    def _exit(self) -> None:
        feed = self.feed
        mine = self.x + self.h + (self.mu, self.done, self.count,
                                  self.pbuf[:, :self.hist], self.dbuf[:, :self.hist])
        for d, t in zip(feed.out, mine):
            d.index_copy_(0, self.group, t[None])
        if feed.warm:
            for d, t in zip(feed.seed, mine):
                d.copy_(t[-1:].expand_as(d))
        self.group.add_(1)

    def run_group(self, capture: bool, pool: Optional[_GraphPool], niter: Optional[int] = None,
                  read_flags=None, all_done: bool = False) -> bool:
        """One group: its entry and its chunks up to ``niter`` (None: the
        program's) through the schedule (:meth:`run_schedule`: the done
        flags read by ``read_flags`` only where a lane can finish, none with
        ``all_done``), then its exit where the feed has one.  Returns
        whether the failure flag is left unread (a composite reads it after
        its last stage: :meth:`_Composite.run`)."""
        chunks = self.schedule(self.cfg.niter if niter is None else niter,
                               self.cfg.interval_update_mu)[1:]
        unread = self.run_schedule(["entry"] + [n for n, _ in chunks], capture, pool,
                                   self.can_finish, read_flags, all_done)
        if self.feed.out is not None:
            self._run_chunk("exit", capture, pool)
        return unread

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the program holds between solves, each memory once
        (a slot may be a field buffer)."""
        feed = self.feed
        return _each_once(self.x + self.h + (self.mu, self.done, self.count, self.pbuf, self.dbuf)
                          + tuple(self._field_buffers()) + tuple(feed.ov.values())
                          + tuple(feed.seed or ()) + (self.group,)
                          + ((feed.done,) if feed.done is not None else ()) + tuple(feed.out or ()))

    @telemetry.spanned("admm.result")
    def result(self) -> "BatchResult":
        """The solve's result, copied out of the buffers that the next solve
        overwrites."""
        return BatchResult(x=tuple(map(torch.clone, self.x)), h=tuple(map(torch.clone, self.h)),
                           mu=self.mu.clone(), iterations=self.count.clone(),
                           converged=self.done.clone(),
                           primal_residual=self.pbuf[:, :self.hist].clone(),
                           dual_residual=self.dbuf[:, :self.hist].clone())


def _phase_program(solver: "BatchedSolver", cfg: ADMMConfig, feed: _Feed, dtype: torch.dtype,
                   tols, record: bool, stride: int, chunked_checks: bool) -> _FedProgram:
    """A fed program of ``solver`` whose groups have the lanes of ``feed``'s
    stacks, its state in ``dtype`` (its buffers sized by group 0's bound
    objectives, bound here on the host)."""
    ov = {k: _cast_like(dtype, v[0]) for k, v in feed.ov.items()}
    gs = (feed.seed[-1][0] if feed.stacked else feed.seed[-1]).shape[0]
    return _FedProgram(solver, cfg, feed, solver._bound(ov), gs, dtype, tols, record, stride,
                       chunked_checks)


class _Composite:
    """What the composite programs share (:class:`_GroupProgram`,
    :class:`_MixedProgram`, ``fused_spm._MixedProgram``): stages that run
    in order on the card, each a program and the call that runs one pass of
    it (None: a group of a fed program, :meth:`_FedProgram.run_group`,
    looked up at each pass; else a call such as a fused solver's
    schedule), as many passes as :attr:`repeats` says.  The failure flags
    of the stages' factorizations are read once, after the last stage: at
    rtol = atol = 0 the composite's one host read before its result.

    With the telemetry switch on, each stage's passes are an ``admm.stage``
    span (attribute ``label``), and on a CUDA device an event is recorded
    on the stream before each stage and after the last (:class:`~admmsolver_
    tpu_torch.utils.telemetry.Marks`): the stages' stream time."""

    def __init__(self, stages, device: torch.device) -> None:
        #: (label of the stage's graph keys, program, one pass: fn(capture,
        #: pool) or None)
        self.stages = stages
        #: passes of each stage in a run
        self.repeats = [1] * len(stages)
        self.device = device
        self._marks: Optional[telemetry.Marks] = None

    @property
    def capture_s(self) -> Dict:
        """Host seconds of each graph's capture, by key (by (label, key)
        where there are several stages)."""
        if len(self.stages) == 1:
            return dict(self.stages[0][1].capture_s)
        return {(label, key): t for label, program, _ in self.stages
                for key, t in program.capture_s.items()}

    def run(self, captures, pool: Optional[_GraphPool]) -> None:
        """Every stage's passes, each captured where ``captures`` says."""
        marks = self._stage_marks()
        for (label, program, step), n, capture in zip(self.stages, self.repeats, captures):
            with telemetry.span("admm.stage", label=label):
                if marks is not None:
                    marks.record(label)
                for _ in range(n):
                    (step or program.run_group)(capture, pool)
        if marks is not None:
            marks.record("end")
        for _, program, _ in self.stages:
            if program.checks:
                raise_if_not_pd(program.failed)

    def _stage_marks(self) -> Optional[telemetry.Marks]:
        """The stages' marks, opened for this run, with the switch on and on
        a CUDA device; else None."""
        if not (telemetry.enabled() and self.device.type == "cuda"):
            return None
        if self._marks is None:
            self._marks = telemetry.Marks("stages_timed", program=type(self).__name__)
        self._marks.begin()
        return self._marks

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the stages hold between solves, each once (a stage
        may seed from another's buffers or share its stacks)."""
        return _each_once(t for _, program, _ in self.stages for t in program.buffers())


class _GroupProgram(_Composite):
    """``solve_path(fused=True)`` and ``solve_scan`` as one program: the JAX
    package's ``_compiled_path`` (``lax.scan`` over warm-started groups,
    ``batch.py:266-304``) and ``run_scan`` (``lax.map`` over groups,
    ``:895-921``).

    It holds the overrides stacked (G, gs, ...) on the card, the seeds (the
    path's first group from the caller's x0, h0 and mu0, then each group's
    from the last lane before it; the scan's stacked initial state), the
    (G, gs, ...) output stacks and one :class:`_FedProgram` that runs every
    group: entry, chunks, exit.  The inputs go to the card once a solve
    (:meth:`load`), the result comes out once (:meth:`result`).

    So the caller's inputs are resident twice while the program is cached:
    the program keeps its stacked copy.  Its key leaves out the number of
    groups: a solve of fewer groups uses the first rows of the stacks, one
    of more grows them (and recaptures the entry and exit, which read and
    write them), so that a solver keeps one set of stacks a key, for its
    largest solve."""

    def __init__(self, solver: "BatchedSolver", cfg: ADMMConfig, stacks: Dict, seed,
                 stacked: bool, tols, record: bool, stride: int, chunked_checks: bool,
                 dtype: torch.dtype) -> None:
        G, gs = next(iter(stacks.values())).shape[:2]
        plan, dev = solver.plan, solver.device
        self.rows = G
        ov = {k: v.clone() for k, v in stacks.items()}
        seed = tuple(a.clone(memory_format=torch.contiguous_format) for a in seed)
        hist = _history_length(cfg.niter, record, stride)
        rdt = _real_dtype(dtype)
        rows = lambda *shape, dt: torch.zeros((G, gs) + shape, dtype=dt, device=dev)
        out = (tuple(rows(n, dt=dtype) for n in plan.block_sizes)
               + tuple(rows(n, dt=dtype) for n in plan.pair_sizes)
               + (rows(plan.npairs, dt=rdt), rows(dt=torch.bool), rows(dt=torch.int32),
                  rows(hist, dt=torch.float64), rows(hist, dt=torch.float64)))
        self.groups = _phase_program(solver, cfg, _Feed(ov, seed, stacked, out=out,
                                                        warm=not stacked),
                                     dtype, tols, record, stride, chunked_checks)
        super().__init__([("groups", self.groups, None)], dev)

    def load(self, stacks: Dict, seed, tols) -> None:
        """A solve's stacks and seeds, its number of groups the stacks'."""
        G = next(iter(stacks.values())).shape[0]
        feed = self.groups.feed
        if G > self.rows:
            grow = lambda a: a.new_zeros((G,) + tuple(a.shape[1:]))
            feed.ov = {k: grow(v) for k, v in feed.ov.items()}
            if feed.stacked:
                feed.seed = tuple(map(grow, feed.seed))
            feed.out = tuple(map(grow, feed.out))
            self.groups.drop_graphs("entry", "exit")
            self.rows = G
        self.repeats = [G]
        self.groups.load(tols, stacks, seed)

    @telemetry.spanned("admm.result")
    def result(self, n: int) -> "BatchResult":
        """The first ``n`` lanes of the output stacks, copied out."""
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))[:n].clone()
        out = tuple(map(flat, self.groups.feed.out))
        nx, nh = len(self.groups.x), len(self.groups.h)
        mu, done, count, pbuf, dbuf = out[nx + nh:]
        return BatchResult(x=out[:nx], h=out[nx:nx + nh], mu=mu, iterations=count,
                           converged=done, primal_residual=pbuf, dual_residual=dbuf)


class _MixedProgram(_Composite):
    """``solve_mixed(fused=True)`` as one program: the JAX package's
    ``_compiled_mixed`` (``batch.py:306-343``).  Two fed programs, the first
    in ``low_dtype`` seeded from the caller's state, the second in the
    solver's dtype seeded from the first's buffers: its entry is the
    hand-off, promoting x, h and mu on the card, every lane not done.  The
    counts are summed and the histories joined on the card
    (:meth:`result`)."""

    def __init__(self, solver: "BatchedSolver", cfgs, stacks: Dict, seed, tols, low_dtype,
                 record: bool, stride: int, chunked_checks: bool) -> None:
        seed = tuple(a.clone(memory_format=torch.contiguous_format) for a in seed)
        ov = {k: v.clone() for k, v in stacks.items()}
        low = _phase_program(solver, cfgs[0], _Feed(ov, seed), low_dtype, tols[0], record,
                             stride, chunked_checks)
        high = _phase_program(solver, cfgs[1], _Feed(ov, low.x + low.h + (low.mu,)),
                              solver.dtype, tols[1], record, stride, chunked_checks)
        self.phases = (low, high)
        super().__init__([("phase 1", low, None), ("phase 2", high, None)], solver.device)

    def load(self, stacks: Dict, seed, tols) -> None:
        low, high = self.phases
        low.load(tols[0], stacks, seed)
        # the second phase shares the stacks; its seeds are the first's state
        high.load(tols[1])

    @telemetry.spanned("admm.result")
    def result(self) -> "BatchResult":
        low, high = self.phases
        joined = lambda name: torch.cat([getattr(p, name)[:, :p.hist] for p in self.phases], 1)
        return BatchResult(x=tuple(map(torch.clone, high.x)), h=tuple(map(torch.clone, high.h)),
                           mu=high.mu.clone(), iterations=low.count + high.count,
                           converged=high.done.clone(), primal_residual=joined("pbuf"),
                           dual_residual=joined("dbuf"))


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

    @telemetry.spanned("admm.init")
    def __init__(self, model: Model, dtype=None, device="cuda", sharding=None) -> None:
        if not isinstance(model, Model):
            raise TypeError(f"expected a Model, got {type(model).__name__}")
        self.sharding = sharding
        self.device = torch.device(device if sharding is None else sharding.mesh.device)
        self.model = model.to(self.device)
        self.plan = ADMMPlan(self.model, self.device)
        # real problems get a real state (see ADMMPlan.is_complex)
        self.dtype = self.plan.default_dtype() if dtype is None else _as_dtype(dtype)
        #: the programs by key, and the memory of their graphs
        self._programs = _ProgramCache(self.device)

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

    def _bound(self, ov: Dict):
        """The objectives of a solve: the prologue's values of ``ov`` bound
        into clones of the template's."""
        return self._bind(self._prologue_overrides(ov))

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

    @telemetry.spanned("admm.inputs")
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
             record: bool, stride: int, chunked_checks: bool) -> BatchResult:
        """One batch through the schedule, as one group of a fed program
        (:meth:`_program`; the JAX package's compiled ``run``, ``batch.py:
        249-264, 405-466``): its entry (the prologue, the overrides bound
        into the field buffers, the factors and iteration 0 from the state
        the solve loads), then chunks of ``interval_update_mu`` iterations
        (those past ``niter`` are not run), each refactoring first, until
        every lane is done (:meth:`_FedProgram.run_group`).  ``ov`` is
        already cast and on the device; ``done0`` is a (B,) mask or None.
        The host reads the done flags, with the failure flag of the
        factorizations, only before a chunk that could be skipped: after a
        chunk that is not the last, and once for a ``done0``; the failure
        flag alone after the last chunk where the model factorizes.  The
        entry and the chunks are replays of captured graphs where the
        solver's cache says (:meth:`_ProgramCache.captures`)."""
        rtol, atol = tols
        hist = _history_length(cfg.niter, record, stride)
        # No lane's flag can change when neither tolerance can be met: then
        # the host never reads the flags.
        can_finish = rtol > 0 or atol > 0
        all_done = done0 is not None and self._all_done(done0)
        # no lane to freeze when none starts done and none can finish
        freeze = can_finish or done0 is not None
        capture = self._programs.captures(self.model.functions, mu.dtype)
        pool = self._programs.graph_pool(capture)
        key = (dataclasses.replace(cfg, niter=0),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(ov.items())),
               record, chunked_checks, stride, mu.shape[0], x[0].dtype, str(self.device), freeze,
               can_finish)
        program = self._programs.program(key, lambda: self._program(
            cfg, ov, mu.shape[0], x[0].dtype, tols, record, stride, chunked_checks, freeze))
        program.reserve(hist)
        program.load(tols, ov, x + h + (mu,), done0, hist)
        if program.run_group(capture, pool, cfg.niter, self._all_done, all_done):
            raise_if_not_pd(program.failed)
        return program.result()

    def _program(self, cfg, ov: Dict, B: int, dtype: torch.dtype, tols, record: bool,
                 stride: int, chunked_checks: bool, freeze: bool) -> _FedProgram:
        """A new one-group fed program of B lanes, its slots and field
        buffers sized by this solve's.  Its key (:meth:`_run`): the JAX package's
        ``(cfg, ov_keys, record, chunked_checks, record_stride)``
        (``batch.py:251-264``) without ``niter`` (the host loop counts the
        chunks, and a longer history takes new buffers:
        :meth:`_GraphProgram.reserve`), with the overrides' shapes and
        dtypes and what the schedule branches on (B, dtype, device, freeze,
        whether a lane can finish); the tolerances are values of the
        program."""
        slots = {k: _fresh(v) for k, v in ov.items()}
        feed = _Feed(slots, None, done=torch.zeros(B, dtype=torch.bool, device=self.device),
                     slots=True)
        return _FedProgram(self, cfg, feed, self._bound(slots), B, dtype, tols, record, stride,
                           chunked_checks, freeze)

    @telemetry.spanned(telemetry.SOLVE)
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
        :meth:`solve_mixed` with 3/4 of the budget in float32 where
        ``niter >= 2`` and is plain at ``niter = 1``; ``"auto"`` (default)
        is plain: when the mixed recipe pays on this hardware has not been
        measured."""
        if recipe not in ("auto", "plain", "mixed"):
            raise ValueError(f"recipe must be auto|plain|mixed, {recipe!r}")
        # niter = 1 cannot split into two positive phases: it runs plain, as
        # in the JAX package (batch.py:524-531)
        if recipe == "mixed" and niter >= 2:
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

    @telemetry.spanned(telemetry.SOLVE)
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

        ``fused=True`` (default) runs the whole path as one program, the
        JAX package's ``lax.scan`` over groups (:class:`_GroupProgram`): the
        values and overrides go to the card once, stacked by group, the last
        group padded by repeating the final value (the padding trimmed from
        the result); each group's prologue, warm start and iteration 0 and
        its copy into the result are steps on the card, captured as graphs
        where the chunks are.  It takes the knobs of :meth:`solve` but
        ``batch_size``, ``done0`` and ``recipe``.  ``fused=False``, a single
        group and a sharded solver take the host loop: one :meth:`solve` a
        group (a sharded solver pads as the program does where ``fused``).
        Both forms give the same lanes.
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
        if fused and gs < n and self.sharding is None:
            return self._solve_path_fused(ov_all, n, gs, **kw)
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

    def _solve_path_fused(self, ov: Dict, n: int, gs: int,
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
                          relax: float = 1.0) -> BatchResult:
        """The path of ``n`` values (``ov``: per value, padded to whole
        groups of ``gs``) through its group program (JAX
        ``_solve_path_fused``, ``batch.py:720-813``); x0, h0 and mu0 start
        the first group."""
        dtype = self._solve_dtype(dtype)
        # batch-field validation, on the whole input (JAX batch.py:770)
        self._validate_overrides(ov)
        G = next(iter(ov.values())).shape[0] // gs
        cfg = self._config(niter, interval_update_mu, update_h, max_mu, fact_incr, th_change,
                           relax)
        record, stride = _parse_record_residuals(record_residuals)
        x, h, mu, _ = self._initial_state(gs, dtype, x0, h0, mu0, None)
        stacks = {k: _cast_like(dtype, v, self.device).reshape((G, gs) + tuple(v.shape[1:]))
                  for k, v in sorted(ov.items())}
        return self._groups("path", cfg, stacks, x + h + (mu,), False, (rtol, atol), record,
                            stride, chunked_checks, dtype).result(n)

    def _groups(self, kind: str, cfg: ADMMConfig, stacks: Dict, seed, stacked: bool, tols,
                record: bool, stride: int, chunked_checks: bool, dtype) -> _GroupProgram:
        """A path or scan through its group program, made on a miss.  The
        key: the JAX package's ``(kind, cfg, ov_keys, record,
        chunked_checks, stride)`` (``batch.py:277``, ``:895``) with the
        shape of a group of each stack and its dtype (not the number of
        groups: :meth:`_GroupProgram.load` grows the stacks), the state
        dtype, the device, whether a lane can finish (and the route switches
        a graph keeps: :class:`_ProgramCache`)."""
        capture = self._programs.captures(self.model.functions, dtype)
        pool = self._programs.graph_pool(capture)
        key = (kind, cfg, tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in stacks.items()),
               record, bool(chunked_checks), stride, dtype, str(self.device),
               tols[0] > 0 or tols[1] > 0)
        program = self._programs.program(key, lambda: _GroupProgram(
            self, cfg, stacks, seed, stacked, tols, record, stride, bool(chunked_checks), dtype))
        program.load(stacks, seed, tols)
        program.run((capture,), pool)
        return program

    @telemetry.spanned(telemetry.SOLVE)
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
        (``optimizer.py:121-152``).

        The groups run as one program, the JAX package's ``lax.map`` over
        groups (:class:`_GroupProgram`): the overrides and initial state go
        to the card once, stacked by group, the last group padded by
        repeating the last instance (trimmed from the result), and each
        group's entry and copy into the result are steps on the card.  A
        sharded solver solves the groups one after another, each rank its
        lanes of each.

        Memory: the inputs are resident twice.  The program keeps its own
        stacked copy of the overrides (all B instances' per-lane A at the
        solver's dtype, beside the caller's tensors) and the (B, ...)
        output stacks for as long as the solver caches it; only one
        group's factors exist at a time.  A later scan of as many groups
        or fewer, with the same group shape, reuses those stacks, and one
        of more groups grows them, so a solver keeps one set a key.

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
        if self.sharding is not None:
            grp = lambda a, s: None if a is None else tuple(v[s:s + g] for v in a)
            return _concat([_shift(self._solve_lanes(
                min(g, B - s), cfg, {k: v[s:s + g] for k, v in overrides.items()},
                self.dtype, grp(x0, s), grp(h0, s), mu0[s:s + g] if mu0.ndim else mu0,
                None, tols, record, stride, bool(chunked_checks)), s)
                for s in range(0, B, g)])
        G = -(-B // g)
        stack = lambda a: _pad_last(a, G * g - B).reshape((G, g) + tuple(a.shape[1:]))
        x, h, mu, _ = self._initial_state(B, self.dtype, x0, h0, mu0, None)
        stacks = {k: stack(_cast_like(self.dtype, v, self.device))
                  for k, v in sorted(overrides.items())}
        return self._groups("scan", cfg, stacks, tuple(map(stack, x + h + (mu,))), True, tols,
                            record, stride, chunked_checks, self.dtype).result(B)

    @telemetry.spanned(telemetry.SOLVE)
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

    @telemetry.spanned(telemetry.SOLVE)
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

        ``fused=True`` runs both phases as one program, the JAX package's
        ``_compiled_mixed`` (:class:`_MixedProgram`): the inputs go to the
        card once, the hand-off promotes the state on the card, and the
        result comes out once; it polishes at the solver dtype only and
        takes the knobs of :meth:`solve` but ``done0``.  ``fused=False``
        (default) and a sharded solver make two :meth:`solve` calls.  Both
        give the same result.
        """
        kw.pop("recipe", None)  # the phases ARE the recipe
        if fused and self.sharding is None:
            if dtype is not None and _as_dtype(dtype) != self.dtype:
                raise ValueError(
                    "the fused mixed solve always polishes at the "
                    "solver dtype; construct the solver with the "
                    "desired full precision or use fused=False")
            return self._solve_mixed_fused(overrides, niter_low, niter, low_dtype, low_rtol,
                                           **kw)
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

    def _solve_mixed_fused(self,
                           overrides: Optional[Dict],
                           niter_low: int,
                           niter: int,
                           low_dtype,
                           low_rtol: float,
                           batch_size: Optional[int] = None,
                           x0: Optional[Sequence] = None,
                           h0: Optional[Sequence] = None,
                           mu0=1.0,
                           interval_update_mu: int = 100,
                           update_h: bool = True,
                           rtol: float = 1e-12,
                           atol: float = 0.0,
                           fact_incr: float = 2.0,
                           th_change: float = 10.0,
                           max_mu: float = 1e3,
                           record_residuals: Union[bool, int] = True,
                           chunked_checks: bool = False,
                           relax: float = 1.0) -> BatchResult:
        """The two phases through their mixed program (JAX
        ``_solve_mixed_fused``, ``batch.py:1044-1114``), made on a miss;
        keyed as the JAX package's ``("mixed", cfg_lo, cfg_hi, ov_keys,
        record, chunked_checks, stride, low_dtype)`` (``batch.py:314``) with
        the overrides' shapes, B, the dtype, the device, whether a lane of
        each phase can finish (and the route switches: :class:`_ProgramCache`)."""
        if niter_low <= 0 or niter <= 0:
            raise ValueError("phase iteration budgets must be positive")
        overrides = dict(overrides or {})
        B = self._batch(overrides, batch_size)
        low = _as_dtype(low_dtype)
        cfgs = tuple(self._config(n, interval_update_mu, update_h, max_mu, fact_incr,
                                  th_change, relax) for n in (niter_low, niter))
        record, stride = _parse_record_residuals(record_residuals)
        tols = ((low_rtol, 0.0), (rtol, atol))
        # phase 1's initial state, as its own solve would take it
        x, h, mu, _ = self._initial_state(B, low, x0, h0, mu0, None)
        stacks = {k: _cast_like(self.dtype, v, self.device)[None]
                  for k, v in sorted(overrides.items())}
        captures = tuple(self._programs.captures(self.model.functions, d)
                         for d in (low, self.dtype))
        pool = self._programs.graph_pool(any(captures))
        key = ("mixed", *cfgs, tuple((k, tuple(v.shape), v.dtype) for k, v in stacks.items()),
               record, bool(chunked_checks), stride, low, B, self.dtype, str(self.device),
               tuple(r > 0 or a > 0 for r, a in tols))
        program = self._programs.program(key, lambda: _MixedProgram(
            self, cfgs, stacks, x + h + (mu,), tols, low, record, stride, bool(chunked_checks)))
        program.load(stacks, x + h + (mu,), tols)
        program.run(captures, pool)
        return program.result()
