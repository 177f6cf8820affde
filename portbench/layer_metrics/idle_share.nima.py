"""1 - device busy a call / host seconds a call outside the traced part
(harness/readers.py:idle_share); a call is one batch of the NIMA loop."""
from portbench.harness.readers import idle_share as read  # noqa: F401
