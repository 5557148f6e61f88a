"""CPU affinity pinning (counterpart of ``fire_tpu.utils.affinity``):
``--core 1`` pins the process to one core as a benchmarking aid.  Only
the host side is affected."""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def set_single_core_affinity(core: int = 0) -> None:
    try:
        os.sched_setaffinity(0, {core})
        log.info("Pinned process to CPU core %d.", core)
    except (AttributeError, OSError) as e:  # platform dependent
        log.warning("Could not set CPU affinity: %s", e)
