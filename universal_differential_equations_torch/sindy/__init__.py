from .basis import (
    Basis,
    Term,
    cos_basis,
    monomial_basis,
    polynomial_basis,
    sin_basis,
    tensor_polynomial_basis,
)
from .collocation import collocate_data
from .optimizers import SR3, STLSQ, STRRidge, masked_lstsq
from .solve import (
    ContinuousDataDrivenProblem,
    DataSampler,
    DirectDataDrivenProblem,
    SINDyResult,
    sindy,
)
