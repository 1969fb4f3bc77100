from .repetition_code import ThreeQubitRepetitionCode  # noqa: F401
from .steane_code import SteaneCode  # noqa: F401
