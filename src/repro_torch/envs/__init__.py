from repro_torch.envs.bsuite_like import Bandit, MemoryChain  # noqa: F401
from repro_torch.envs.cartpole import CartpoleSwingup, PendulumSwingup  # noqa: F401
from repro_torch.envs.catch import Catch  # noqa: F401
from repro_torch.envs.deep_sea import DeepSea  # noqa: F401
from repro_torch.envs.token_lm import TokenChain  # noqa: F401
from repro_torch.envs.vector import VectorEnv, split_timestep, stack_timesteps  # noqa: F401
