from .grids import norm, second_deriv_prj, smooth_regularizer_coeff
