from .profiling import timed, trace, log_compiles, gpu_card
from .diagnostics import health_check

__all__ = ["timed", "trace", "log_compiles", "gpu_card", "health_check"]
