from pinn_torch.optim.adam import AdamRunner  # noqa: F401
from pinn_torch.optim.lbfgs import (LbfgsConfig, LbfgsState, lbfgs_init,  # noqa: F401
                                    make_lbfgs_run)
