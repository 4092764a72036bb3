"""fedml_tpu_torch — the PyTorch + CUDA port of ``fedml_tpu`` for one NVIDIA
H100.

It lives beside the JAX package, which stays the reference, and imports
nothing from it (nor JAX).  The top-level API mirrors it: ``init()``,
``run_simulation()`` and the typed ``Config``.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Optional

__version__ = "0.1.0"

from . import constants  # noqa: E402
from .arguments import Config, add_args, load_arguments  # noqa: E402


def init(args: Optional[Config] = None, argv=None) -> Config:
    """Parse args/YAML, seed host RNGs, set up logging."""
    from .core import rng

    cfg = args if args is not None else add_args(argv)
    rng.seed_everything(cfg.random_seed)
    logging.basicConfig(level=logging.INFO,
                        format="[fedml_tpu_torch] %(asctime)s %(levelname)s %(message)s")
    # MULTIPROCESS / MPI, or a silo spanning processes: the gloo process
    # group comes up here (the only place), as the reference's
    # jax.distributed does
    from .core.flags import cfg_extra
    from .parallel import multihost

    requested = getattr(cfg, "backend_sim", "") in ("MULTIPROCESS",
                                                     constants.SIMULATION_BACKEND_MPI)
    if requested or cfg_extra(cfg, "coordinator_address"):
        multihost.ensure_initialized(cfg)
        if requested and not multihost.is_initialized():
            # an explicit multi-process backend never degrades to one process
            raise ValueError(multihost.MULTIPROCESS_REFUSAL)
    return cfg


def run_simulation(cfg: Optional[Config] = None, device=None):
    """One-line simulation entry."""
    from .runner import FedMLRunner

    return FedMLRunner(init(cfg), device=device).run()
