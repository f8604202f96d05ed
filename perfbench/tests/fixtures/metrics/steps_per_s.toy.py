"""A toy per-layer metric that a later change might add: decode steps or
training steps a second of span time, over the window."""


def read(run):
    spans = run.spans("decode step") + run.spans("train step")
    total = sum(s.seconds for s in spans)
    return len(spans) / total if total else None
