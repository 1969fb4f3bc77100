from .framework import QuantumErrorCode, Decoder, QEC_Experiment  # noqa: F401
from .codes.repetition_code import ThreeQubitRepetitionCode  # noqa: F401
from .decoders.repetition_decoder import RepetitionCodeDecoder  # noqa: F401
from .codes.steane_code import SteaneCode  # noqa: F401
from .decoders.steane_decoder import SteaneDecoder  # noqa: F401
