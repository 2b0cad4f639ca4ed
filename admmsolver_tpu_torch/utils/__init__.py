from .grids import (norm, second_deriv_banded, second_deriv_prj,
                    smooth_regularizer_banded, smooth_regularizer_coeff)
from .checkpoint import (
    save_state,
    load_state,
    restore_optimizer,
    save_batch_result,
    load_batch_result,
)
from .telemetry import (trace, convergence_report, check_finite_state,
                        debug_nans)
