"""Drivers: ``cooc_serve`` builds or opens a store and replays a Zipf query
workload through the in-process engine."""
