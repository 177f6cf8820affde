"""1 - device busy a call / host seconds a call outside the traced part
(harness/readers.py:idle_share)."""
from portbench.harness.readers import idle_share as read  # noqa: F401
