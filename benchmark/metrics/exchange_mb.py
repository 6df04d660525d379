"""exchange_mb (MB, ranks layer): the bytes of the tensors rank 0 hands
to its collectives in one sync, its own share included, in 1e6 bytes,
the mean over the traced window's syncs. None at one rank."""


def read(rec):
    ex = rec.get("exchange")
    return sum(b for _, b in ex) / len(ex) / 1e6 if ex else None
