"""Host-side scheduling for the cached engine: the native planner binding
(`planner.py`, built by `build.py`), capacity sizing and plan tapes."""
