"""Runtime support: work-unit fault tolerance (``runtime/fault.py``) and
env-gated fault injection (``runtime/faultinject.py``) for scripting
failures into serving workers."""
