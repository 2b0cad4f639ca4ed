from .objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    NonNegativePenalty,
)
from .problem import EqualityCondition, Model, Problem
from .applications import (basis_pursuit_model, lasso_model, spm_model,
                           synthetic_spm_data)
from .realify import (
    RealifiedModel,
    RealPartProx,
    realify_matrix,
    realify_model,
    realify_objective,
)
