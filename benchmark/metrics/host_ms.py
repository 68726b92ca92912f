"""host_ms: the host clock inside ``tryon_step`` less its blocking copy to
the card (signatures, argument copies, replays' launches, output clones),
mean a request of the traced window."""


def read(rec):
    return rec.get("host_ms")
