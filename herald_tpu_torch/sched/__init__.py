"""Host-side scheduling: the cached engine's planner binding (`planner.py`),
capacity sizing and plan tapes, and assign-only mode's lookahead sample
scheduler (`scheduler.py`, with its numpy mirror `pysched.py`, and its
one-planner fan-out over ranks, `service.py`); both native libraries are
built by `build.py`."""
