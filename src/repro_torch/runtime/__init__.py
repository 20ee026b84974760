"""Runtime support: work-unit fault tolerance (``runtime/fault.py``),
env-gated fault injection (``runtime/faultinject.py``) for scripting
failures into serving workers, and elastic re-meshing
(``runtime/elastic.py``)."""
