"""Share of its roofline that the f32 fused kernel reaches on the complex
carry (re and im float32 planes, both read and written a launch; the
dense two-qubit case counted at its FP32 instructions) over the traced
window, in % (``roofline_c64.py``)."""

from portbench import roofline_c64


def read(rec):
    return roofline_c64.share(rec)
