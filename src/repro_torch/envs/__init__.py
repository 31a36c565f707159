from repro_torch.envs.catch import Catch  # noqa: F401
from repro_torch.envs.vector import VectorEnv, split_timestep, stack_timesteps  # noqa: F401
