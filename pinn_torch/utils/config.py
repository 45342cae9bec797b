"""Config system: hp dicts with the reference's key names.

The reference configures every experiment through a plain ``hp`` dict,
optionally loaded from a JSON file passed as ``argv[1]``
(reference 1d-burgers/inf_cont_burgers.py:23-43), and persists it next
to results (reference utils/plotting.py:15-16).  The same contract is
kept here — identical key names (``N_u``, ``N_f``, ``layers``,
``tf_epochs``, ``tf_lr``, ``tf_b1``, ``tf_eps``, ``nt_epochs``,
``nt_lr``, ``nt_ncorr``, ``log_frequency``, ...) so a reference user's
hp.json files drop in unchanged.  TPU-specific extras are namespaced
with a ``tpu_`` prefix and all optional.

A copy of ``pinn/utils/config.py`` (json only, so the port need not
import the JAX package), plus the port's own ``device`` key.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

HP = Dict  # hp dicts are plain dicts, as in the reference


def load_hp(argv: Optional[List[str]] = None, defaults: Optional[HP] = None) -> HP:
    """Reference CLI contract: ``script [hp.json]``.

    If ``argv`` has a path argument, load hp from that JSON file;
    otherwise return ``defaults``.  Keys present in the JSON override
    defaults rather than replacing the dict wholesale, so partial
    configs are valid.
    """
    hp = dict(defaults or {})
    if argv and len(argv) > 1:
        with open(argv[1]) as fh:
            hp.update(json.load(fh))
    return hp


def save_hp(hp: HP, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(hp, fh)


# Keys every training run needs (reference hp contract) and the extras
# this framework adds.  Used for friendly validation errors.
REQUIRED_KEYS = ("layers",)
KNOWN_KEYS = {
    "N_u", "N_f", "N_0", "N_1", "N_n", "N_b", "q", "layers",
    "tf_epochs", "tf_lr", "tf_b1", "tf_eps",
    "nt_epochs", "nt_lr", "nt_ncorr", "log_frequency",
    # framework extras
    "dtype", "nt_line_search", "nt_restart", "nt_vector_dtype",
    "tf_net_dtype",
    "trace_dir", "init_checkpoint", "save_checkpoint", "seed",
    "tf_resample", "nt_resample", "model_description", "tpu_mesh",
    "fused_residual", "rar_pool", "rar_init", "log_file", "init_seed",
    "nt_dir_impl", "print_loss_terms", "save_every", "net_impl",
    "nt_val_every",
    # pinn_torch: the device a run uses ("cuda", "cpu"; absent = "cuda")
    "device",
    # Navier-Stokes dataset selection/geometry
    # (experiments/ide_cont_navierstokes)
    "dataset", "grid_nx", "grid_ny", "grid_nt", "t_max",
}


def validate_hp(hp: HP, required=REQUIRED_KEYS) -> HP:
    """Check required keys and warn on unknown ones (typo guard).

    Returns hp unchanged so it can be used inline.
    """
    missing = [k for k in required if k not in hp]
    if missing:
        raise KeyError(
            f"hp is missing required key(s) {missing}; the reference key "
            f"names are used here (see pinn_torch/utils/config.py KNOWN_KEYS)")
    unknown = sorted(set(hp) - KNOWN_KEYS)
    if unknown:
        import warnings
        warnings.warn(f"unknown hp key(s) {unknown} — typo? "
                      f"(known: sorted KNOWN_KEYS in pinn_torch/utils/config.py)",
                      stacklevel=2)
    return hp
