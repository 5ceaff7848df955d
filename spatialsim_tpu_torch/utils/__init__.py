"""Shared utilities: logging, timers, profiling (SURVEY.md §5 aux)."""

from spatialsim_tpu_torch.utils.logging import log, set_verbosity  # noqa: F401
from spatialsim_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer, trace, profile_step)
