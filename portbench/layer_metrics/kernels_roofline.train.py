"""Σ bound / Σ device time of the hand-written kernels found by name in the
traced window (harness/readers.py:roofline)."""
from portbench.harness.readers import roofline as read  # noqa: F401
