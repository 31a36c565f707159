from repro_torch.networks.heads import dueling_apply, dueling_init  # noqa: F401
from repro_torch.networks.lstm import (  # noqa: F401
    LSTMNetwork, lstm_apply, lstm_init, lstm_initial_state)
from repro_torch.networks.mlp import MLP, flatten_obs, mlp_apply, mlp_init  # noqa: F401
