from pinn_torch.problems import allencahn, burgers, kdv, navierstokes, schrodinger  # noqa: F401
