from .network import (
    ModelConfig,
    flatten_params,
    init_params,
    param_count,
    param_tree,
    params_from_flat,
    params_to_flat,
    unflatten_params,
)
