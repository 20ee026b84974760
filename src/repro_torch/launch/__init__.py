"""Drivers: ``cooc_run`` counts a df-remapped collection into a pairs file or
a store through the planner and the resumable executor; ``cooc_serve``
builds or opens a store and replays a Zipf query workload through the
in-process engine."""
