"""Operations and bytes of one loss evaluation, one module a problem:
``cost(cfg, n_f, grads) -> (operations, bytes)`` at the configuration's
layers and ``n_f`` collocation points, with (``grads``) or without its
gradients.  The count is the least work the loss needs, whichever
kernel does it."""
