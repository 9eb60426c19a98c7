"""Host ms a step in the planner instance's `pop_chunk` over the window:
the wait for the planner's programs and their copy out of it."""


def read(r):
    if not r.steps or "pop_chunk" not in r.spans:
        return None
    return r.spans["pop_chunk"] / r.steps * 1e3
