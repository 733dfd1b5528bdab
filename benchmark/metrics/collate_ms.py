"""Host time of the data path a training step: BucketedCollater on the
step's utterances and to_device's pinned upload, from the `collate` spans
over the whole window, in ms."""


def read(r):
    spans = (r.spans or {}).get("collate")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
