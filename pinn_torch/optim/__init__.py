from pinn_torch.optim.lbfgs import (LbfgsConfig, LbfgsState, lbfgs_init,  # noqa: F401
                                    make_lbfgs_run)
