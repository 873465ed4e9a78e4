from repro_torch.fl.client import (  # noqa: F401
    StackedClients, empirical_errors, init_client_params,
    pairwise_disagreement, stack_clients, train_sources, true_accuracies,
)
from repro_torch.fl.divergence import (  # noqa: F401
    estimate_divergences, update_divergences,
)
from repro_torch.fl.round import (  # noqa: F401
    MethodResult, RoundState, evaluate_assignment, make_bounds,
    prepare_round, run_stlf, train_local,
)
from repro_torch.fl.transfer import (  # noqa: F401
    apply_transfer, column_normalize, combine_models,
)
