"""Checkpoint / resume for ADMM solver state.

Counterpart of :mod:`admmsolver_tpu.utils.checkpoint`.  The reference has
no persistence: its only resume mechanism is the manual ``x0`` warm start
(``optimizer.py:141-163``).  The carry state ``(x, h, mu, histories)`` is
written with ``numpy.savez`` in exactly the JAX package's layout — the keys
``x_i``, ``h_i``, ``mu``, ``iterations``, ``converged``,
``primal_residual``, ``dual_residual`` (and ``lane_index`` in a scattered
shard) beside a JSON ``__meta__`` of format version 1 — so a file written by
either package loads in the other.  Tensors go to the host to be written;
loads place them on ``device`` (``cuda`` unless the caller says otherwise).
"""
from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state", "restore_optimizer",
           "save_batch_result", "load_batch_result",
           "save_batch_result_local", "load_batch_result_scattered"]

_FORMAT_VERSION = 1
_BATCH_FIELDS = ("mu", "iterations", "converged", "primal_residual", "dual_residual")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _meta(z, path) -> dict:
    meta = json.loads(str(z["__meta__"]))
    if meta.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')} in {path}")
    return meta


def save_state(path: str, opt) -> None:
    """Persist a :class:`SimpleOptimizer`'s resumable state."""
    arrays = {f"x_{i}": _host(x_) for i, x_ in enumerate(opt._x)}
    arrays.update({f"h_{i}": _host(h_) for i, h_ in enumerate(opt._h)})
    arrays["mu"] = _host(opt._mu)
    arrays["primal_residual"] = np.asarray(opt._primal_residual)
    arrays["dual_residual"] = np.asarray(opt._dual_residual)
    meta = {"version": _FORMAT_VERSION, "nblocks": len(opt._x),
            "npairs": len(opt._h), "max_mu": opt._max_mu}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_state(path: str) -> dict:
    """Load raw checkpoint contents (numpy arrays)."""
    with np.load(path, allow_pickle=False) as z:
        meta = _meta(z, path)
        return {
            "meta": meta,
            "x": [z[f"x_{i}"] for i in range(meta["nblocks"])],
            "h": [z[f"h_{i}"] for i in range(meta["npairs"])],
            "mu": z["mu"],
            "primal_residual": z["primal_residual"].tolist(),
            "dual_residual": z["dual_residual"].tolist(),
        }


def restore_optimizer(path: str, model, dtype=None, device="cuda"):
    """Rebuild a warm-started :class:`SimpleOptimizer` on ``device`` from a
    checkpoint.  The model must match the checkpoint's block/pair structure
    (shapes are validated on restore)."""
    from ..optimizer import SimpleOptimizer

    state = load_state(path)
    opt = SimpleOptimizer(model, x0=state["x"], max_mu=state["meta"]["max_mu"],
                          dtype=dtype, device=device)
    if len(state["h"]) != len(opt._h):
        raise ValueError(f"checkpoint has {len(state['h'])} dual blocks, model needs "
                         f"{len(opt._h)}")
    for restored, expected in zip(state["h"], opt._h):
        if restored.shape != tuple(expected.shape):
            raise ValueError(f"dual shape mismatch: {restored.shape} vs {tuple(expected.shape)}")
    opt._h = tuple(torch.as_tensor(h_, device=device) for h_ in state["h"])
    opt._mu = torch.as_tensor(state["mu"], device=device)
    opt._primal_residual = list(state["primal_residual"])
    opt._dual_residual = list(state["dual_residual"])
    return opt


def _batch_arrays(res) -> dict:
    arrays = {f"x_{i}": _host(x_) for i, x_ in enumerate(res.x)}
    arrays.update({f"h_{i}": _host(h_) for i, h_ in enumerate(res.h)})
    arrays.update({name: _host(getattr(res, name)) for name in _BATCH_FIELDS})
    return arrays


def _batch_result(get, meta, device):
    from ..parallel.batch import BatchResult

    t = lambda a: torch.as_tensor(a, device=device)
    return BatchResult(
        x=tuple(t(get(f"x_{i}")) for i in range(meta["nblocks"])),
        h=tuple(t(get(f"h_{i}")) for i in range(meta["npairs"])),
        **{name: t(get(name)) for name in _BATCH_FIELDS})


def save_batch_result(path: str, res) -> None:
    """Persist a :class:`BatchResult` (e.g. to resume a λ-sweep through
    ``BatchedSolver.solve(x0=..., h0=..., mu0=...)``)."""
    meta = {"version": _FORMAT_VERSION, "nblocks": len(res.x), "npairs": len(res.h)}
    np.savez(path, __meta__=json.dumps(meta), **_batch_arrays(res))


def load_batch_result(path: str, device="cuda"):
    """A :class:`BatchResult` from :func:`save_batch_result` (of either
    package), its tensors on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        return _batch_result(lambda k: z[k], _meta(z, path), device)


def save_batch_result_local(path: str, res) -> None:
    """Persist this process's lanes of a :class:`BatchResult` with their
    global lane indices, in the JAX package's shard layout: every rank of a
    sharded solve writes its own file (e.g. ``f"ckpt_p{mesh.rank}.npz"``),
    with no gather.  Reassemble with :func:`load_batch_result_scattered`.
    The lanes of an unsharded result are lanes ``0..B-1``."""
    arrays = _batch_arrays(res)
    arrays["lane_index"] = (np.arange(arrays["x_0"].shape[0]) if res.lane_index is None
                            else _host(res.lane_index))
    meta = {"version": _FORMAT_VERSION, "nblocks": len(res.x),
            "npairs": len(res.h), "scattered": True}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_batch_result_scattered(paths, device="cuda"):
    """Reassemble a :class:`BatchResult` from shard files written by
    :func:`save_batch_result_local` (in any order; lanes are sorted back
    into global order), its tensors on ``device``."""
    parts, meta0 = [], None
    for path in paths:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("version") != _FORMAT_VERSION or not meta.get("scattered"):
                raise ValueError(f"{path} is not a scattered checkpoint shard (meta={meta})")
            meta0 = meta0 or meta
            parts.append({k: z[k] for k in z.files if k != "__meta__"})
    order = np.argsort(np.concatenate([p["lane_index"] for p in parts]))
    cat = lambda name: np.concatenate([p[name] for p in parts], axis=0)[order]
    return _batch_result(cat, meta0, device)
