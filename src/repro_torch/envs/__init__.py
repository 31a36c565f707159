from repro_torch.envs.catch import Catch  # noqa: F401
