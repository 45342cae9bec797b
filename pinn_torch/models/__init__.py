from pinn_torch.models import mlp  # noqa: F401
from pinn_torch.models.mlp import MLP, init_mlp, apply, taylor_apply  # noqa: F401
