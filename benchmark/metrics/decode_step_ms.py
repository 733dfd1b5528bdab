"""Host time of the beam search a decode step over the whole window: the
`search` spans (beam_search, synchronised at its end) over the decode steps,
counted by K1's launch counter over the decoder's layers, in ms."""


def read(r):
    search = (r.spans or {}).get("search")
    steps = r.stats.get("k1_launches", 0) / r.shape.n_decoder_layers
    if not search or steps <= 0:
        return None
    return 1e3 * sum(search) / steps
