from repro_torch.models import attention, config, layers, moe, ssm, transformer  # noqa: F401
from repro_torch.models.config import ArchConfig, InputShape, MoEConfig, SSMConfig  # noqa: F401
