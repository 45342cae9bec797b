from pinn_torch.problems import burgers  # noqa: F401
