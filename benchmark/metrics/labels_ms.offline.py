"""Mean host time of one ``self_soft_labels`` call in the window, its wait
for the work queued before it included (host clock)."""


def read(run):
    spans = run.spans.get("labels", [])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
