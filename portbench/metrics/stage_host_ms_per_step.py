"""Host ms a step inside `train_epoch_cached` apart from its pops: the
chunk's program (`_chunk_program`), its pack and copy, the memo and the
steps' dispatch."""


def read(r):
    s = r.spans
    if not r.steps or "train_epoch_cached" not in s:
        return None
    return (s["train_epoch_cached"] - s.get("pop_chunk", 0.0)) / r.steps \
        * 1e3
