"""Rows pulled into the cache (misses and refreshes) over the window, in
percent of the ids the steps read (batch x fields a step): the planner's
counters (`CachePlanner.perf`), their change over the window. The
counters run at the planner's position, at most its queue ahead of the
steps. It covers the whole window, the traced stretch too."""


def read(r):
    c = r.counters
    if not r.window_steps or "miss_pull" not in c:
        return None
    ids = r.window_steps * r.cfg["batch_size"] * r.cfg["num_sparse"]
    return 100.0 * (c["miss_pull"] + c["update_pull"]) / ids
