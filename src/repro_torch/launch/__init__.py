"""Drivers: ``cooc_run`` counts a df-remapped collection into a pairs file or
a store through the planner and the resumable executor (or, with
``--ingest-workers N``, the parallel one); ``cooc_serve`` builds or opens a
store and replays a Zipf query workload through the in-process engine or
serving workers; ``cooc_stream`` tails a feed into a live store. ``mesh``
builds the ``DeviceMesh``es of the multi-device paths. ``serve`` serves an
LM; ``train`` holds the train-step factories and ``train_lm`` trains an LM
with checkpoints and resume."""
