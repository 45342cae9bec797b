"""``python -m pinn_torch`` — see :mod:`pinn_torch.cli`."""

import sys

from pinn_torch.cli import main

sys.exit(main())
