"""Solver configuration.

The same knobs as :class:`admmsolver_tpu.config.ADMMConfig`, the loop
schedule of one ``solve()`` call.  PyTorch runs eagerly, so here they are
plain values read by the Python loop rather than static jit arguments.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Knobs of the ADMM loop.

    Matches reference defaults: ``niter``/``interval_update_mu``/
    ``update_h`` (``optimizer.py:302-309``), ``fact_incr``/``th_change``
    (``optimizer.py:277``), ``max_mu`` (``optimizer.py:125``).
    Tolerances are ``solve()`` arguments, not fields.
    """

    niter: int = 10000
    interval_update_mu: int = 100
    update_h: bool = True
    fact_incr: float = 2.0
    th_change: float = 10.0
    max_mu: float = 1e3
    #: Over-relaxation factor (no reference counterpart).  1.0 = off,
    #: exactly the reference sweep.  Single-pair (2-block) models only;
    #: the engine raises otherwise.
    relax: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "ADMMConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ADMMConfig keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_yaml(cls, path: str) -> "ADMMConfig":
        """Load knobs from a YAML file (benchmark-harness convenience;
        the library itself never reads files).  Requires ``pyyaml``."""
        try:
            import yaml
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "ADMMConfig.from_yaml needs pyyaml; install the yaml "
                "extra: pip install admmsolver_tpu[yaml]") from e

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})
