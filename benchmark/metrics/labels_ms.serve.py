"""Mean host time of one ``EnhanceService._labels_for_batch`` call in the
window (the label network over the batch's lip clips, or the self-soft
classifier), its wait for the batch in flight on the card included (host
clock)."""


def read(run):
    spans = run.spans.get("labels", [])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
