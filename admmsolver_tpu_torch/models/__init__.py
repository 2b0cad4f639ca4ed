from .objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    L1Regularizer,
    NonNegativePenalty,
)
from .problem import EqualityCondition, Model, Problem
