"""Problem graph: objectives coupled by pairwise equality constraints.

Counterpart of :mod:`admmsolver_tpu.models.problem` (reference
``optimizer.py:12-118``).  The coupling products ``EcE[k,i] = E[i,k]†
E[k,i]`` and ``EcE2[k,i] = E[k,i]† E[k,i]`` are precomputed through the
structured matmul dispatch (``optimizer.py:71-76``), so identity-coupled
pairs stay scaled identities.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.linop import MatrixBase, asmatrixtype, matmul
from .objectivefunc import ObjectiveFunctionBase

__all__ = ["EqualityCondition", "Model", "Problem"]


class PairMap(dict):
    """Coupling map indexed by block pairs.

    Supports both ``E[i, j]`` and ``E[(i, j)]`` and returns ``None`` for
    uncoupled pairs, matching the reference's ``None``-filled object
    ndarray (``optimizer.py:56-58``)."""

    def __missing__(self, key):
        return None


class EqualityCondition:
    """Coupling ``E1 @ x_{i1} - E2 @ x_{i2} = 0`` with ``i1 != i2``
    (reference ``optimizer.py:12-38``)."""

    def __init__(self, i1: int, i2: int,
                 E1: Union[np.ndarray, torch.Tensor, MatrixBase],
                 E2: Union[np.ndarray, torch.Tensor, MatrixBase]) -> None:
        assert i1 != i2, "i1 != i2!"
        assert E1.shape[0] == E2.shape[0], \
            "Leading dimensions of E1 and E2 do not match!"
        assert E1.ndim == 2 and E2.ndim == 2
        self.i1 = int(i1)
        self.i2 = int(i2)
        self.E1 = asmatrixtype(E1)
        self.E2 = asmatrixtype(E2)

    @property
    def size(self) -> int:
        return self.E1.shape[0]


class Model:
    """Objective list + constraint graph with precomputed coupling products.

    Reference: ``optimizer.py:40-118``.  Accepts legacy ``(i1, i2, E1, E2)``
    tuples for compatibility (``optimizer.py:62-64``).
    """

    def __init__(self,
                 functions: Sequence[ObjectiveFunctionBase],
                 equality_conditions: Union[tuple, List] = ()) -> None:
        for f in functions:
            assert isinstance(f, ObjectiveFunctionBase), type(f)
        self._functions = list(functions)
        self._num_func = len(functions)
        # E[(i, j)]: operator applied to x_j in the constraint coupling
        # blocks i and j; populated symmetrically like the reference's
        # object array (optimizer.py:113-114).
        self._E: Dict[Tuple[int, int], MatrixBase] = PairMap()
        self._EcE: Dict[Tuple[int, int], MatrixBase] = PairMap()
        self._EcE2: Dict[Tuple[int, int], MatrixBase] = PairMap()

        for ie, e in enumerate(equality_conditions):
            try:
                if isinstance(e, tuple):
                    e = EqualityCondition(*e)
                self._add_equality_condition(e)
            except Exception:
                print(f"Error occured when adding {ie}-th equality condition!")
                raise

        for i in range(self._num_func):
            for k in range(self._num_func):
                if (k, i) not in self._E:
                    continue
                # EcE[k,i] = E[i,k]† E[k,i]; EcE2[k,i] = E[k,i]† E[k,i]
                # (optimizer.py:71-76)
                self._EcE[(k, i)] = matmul(self._E[(i, k)].conjugate().T,
                                           self._E[(k, i)])
                self._EcE2[(k, i)] = matmul(self._E[(k, i)].conjugate().T,
                                            self._E[(k, i)])

    def to(self, device) -> "Model":
        """The same model with every tensor on ``device``."""
        m = object.__new__(Model)
        m._functions = [f.to(device) for f in self._functions]
        m._num_func = self._num_func
        for name in ("_E", "_EcE", "_EcE2"):
            setattr(m, name, PairMap(
                {k: op.to(device) for k, op in getattr(self, name).items()}))
        return m

    # -- accessors (reference property names) -----------------------------
    @property
    def functions(self) -> Sequence[ObjectiveFunctionBase]:
        return self._functions

    @property
    def num_func(self) -> int:
        return self._num_func

    @property
    def E(self) -> Dict[Tuple[int, int], MatrixBase]:
        return self._E

    @property
    def EcE(self) -> Dict[Tuple[int, int], MatrixBase]:
        return self._EcE

    @property
    def EcE2(self) -> Dict[Tuple[int, int], MatrixBase]:
        return self._EcE2

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        """Coupled pairs (i, j) with i > j, in the reference's row-major
        iteration order (``optimizer.py:156-160,235-236``)."""
        return sorted(
            (i, j) for (i, j) in self._E.keys() if i > j)

    def _add_equality_condition(self, e: EqualityCondition) -> None:
        assert isinstance(e, EqualityCondition)
        assert e.E1.shape[1] == self._functions[e.i1].size_x, \
            f"{e.E1.shape} {self._functions[e.i1].size_x}"
        assert e.E2.shape[1] == self._functions[e.i2].size_x, \
            f"{e.E2.shape} {self._functions[e.i2].size_x}"
        if (e.i1, e.i2) in self._E:
            raise RuntimeError("Duplicate entries in equality_conditions")
        self._E[(e.i2, e.i1)] = e.E1
        self._E[(e.i1, e.i2)] = e.E2


# Backward compatibility (optimizer.py:118)
Problem = Model
