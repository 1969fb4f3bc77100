from .repetition_decoder import RepetitionCodeDecoder  # noqa: F401
from .steane_decoder import SteaneDecoder  # noqa: F401
