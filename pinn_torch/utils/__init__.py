from pinn_torch.utils.config import HP, load_hp  # noqa: F401
from pinn_torch.utils.logger import Logger  # noqa: F401
