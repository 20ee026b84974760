"""Runtime support: work-unit fault tolerance (``runtime/fault.py``)."""
