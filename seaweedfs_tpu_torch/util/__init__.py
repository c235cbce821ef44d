"""util — helpers shared by the EC path."""

from .profiling import StageTimer  # noqa: F401
