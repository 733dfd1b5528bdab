"""Small sizes of the cells for the CPU tests: the configurations at a tenth
of the encoder's width, a decoder of 32, a vocabulary of 50 + 16 speakers;
mixes of a few short rows."""
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def config(name="tal-1x", **kw):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        c = json.load(f)
    c.update(width_mult=0.1, d_decoder_override=32, vocab_size=50, num_speakers=16)
    c.update(kw)
    return c


def mix(name, **kw):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as f:
        m = json.load(f)
    if m["kind"] == "generate":
        m.update(batch=4, window_seconds=2.0, max_new_tokens=8, pool=2, trace_calls=1,
                 check_rows=2, check_calls=2)
    else:
        m.update(batch=4, min_seconds=1.0, max_seconds=2.0, pool=16, audio_buckets=[1, 2],
                 text_buckets=[8, 16], warm_steps=1, trace_steps=1)
    m.update(kw)
    return m
