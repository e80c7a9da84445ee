"""The whole step's share of the H100's peak: the operations of the traced
window's work, counted from shapes (`roofline/counts.py`), each against
the peak of the precision it runs in, over the traced window, in
percent."""

from benchmark.trace import mfu_percent as read  # noqa: F401
