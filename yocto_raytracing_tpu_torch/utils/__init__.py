from .logging import Timer, get_logger, log_phase  # noqa: F401
from .config import RenderConfig  # noqa: F401
