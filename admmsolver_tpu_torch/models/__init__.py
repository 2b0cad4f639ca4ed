from .objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    GroupL1Regularizer,
    HuberLoss,
    NonNegativePenalty,
    NuclearNormPenalty,
    BoxProjectionPenalty,
    SemiPositiveDefinitePenalty,
)
from .problem import EqualityCondition, Model, Problem
from .applications import (basis_pursuit_model, bounded_lsq_model,
                           covariance_denoise_model, group_lasso_model,
                           lasso_model, portfolio_model, robust_regression_model,
                           rpca_model, sdp_model, spm_model, synthetic_spm_data,
                           tv_denoise_model)
from .realify import (
    RealifiedModel,
    RealPartProx,
    realify_matrix,
    realify_model,
    realify_objective,
)
