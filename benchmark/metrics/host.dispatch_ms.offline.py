"""Mean host time of one ``Enhancer._dispatch`` in the window (pad, PCM16,
upload and the enqueue of the whole device program), host clock."""


def read(run):
    spans = run.spans.get("dispatch", [])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
