from repro_torch.models import attention, config, layers, ssm, transformer  # noqa: F401
from repro_torch.models.config import ArchConfig  # noqa: F401
