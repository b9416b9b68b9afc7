"""Host time between the replays of a chunked training epoch: the mean gap,
in ms, between the end of one ``epoch.chunk`` span and the start of the
next in the traced epoch (the program's span recorder on for it), which is
the host work that running an epoch in chunks adds."""


def read(r: dict):
    if r.get("kind") != "train" or not r.get("chunk_gaps"):
        return None
    return 1e3 * r["chunk_gap_s"] / r["chunk_gaps"]
