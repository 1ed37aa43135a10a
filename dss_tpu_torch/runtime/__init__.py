from .messages import TimeSeriesMessage, ClosedLoopMessage
from .graph import (
    Settings,
    State,
    Unit,
    System,
    InputStream,
    OutputStream,
    NetworkDefinition,
    subscriber,
    publisher,
    main_loop,
    coalescing,
    run_system,
)

__all__ = [
    "TimeSeriesMessage",
    "ClosedLoopMessage",
    "Settings",
    "State",
    "Unit",
    "System",
    "InputStream",
    "OutputStream",
    "NetworkDefinition",
    "subscriber",
    "publisher",
    "main_loop",
    "coalescing",
    "run_system",
]
