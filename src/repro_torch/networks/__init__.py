from repro_torch.networks.heads import (  # noqa: F401
    CategoricalParams, categorical_apply, categorical_init, dueling_apply,
    dueling_init, gaussian_policy_apply, gaussian_policy_init)
from repro_torch.networks.lstm import (  # noqa: F401
    LSTMNetwork, lstm_apply, lstm_init, lstm_initial_state)
from repro_torch.networks.mlp import MLP, flatten_obs, mlp_apply, mlp_init  # noqa: F401
