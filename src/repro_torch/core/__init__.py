"""ST-LF core: bounds, energy model, problem (P) and its solver."""
from repro_torch.core.bounds import (  # noqa: F401
    BoundTerms, source_term, target_term,
)
from repro_torch.core.energy import EnergyModel  # noqa: F401
from repro_torch.core.problem import STLFProblem  # noqa: F401
from repro_torch.core.solver import SolverResult, solve_stlf  # noqa: F401
