"""Host ms a step inside `Engine.train_epoch`: packing the chunk's
inputs on the card and dispatching its steps."""


def read(r):
    if not r.steps or "train_epoch" not in r.spans:
        return None
    return r.spans["train_epoch"] / r.steps * 1e3
