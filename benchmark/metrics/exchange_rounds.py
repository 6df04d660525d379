"""exchange_rounds (rounds, ranks layer): the collective calls rank 0
makes in one sync (all_gather, all_reduce, all_reduce_flag, all_to_all,
ragged_all_to_all, ppermute), the mean over the traced window's syncs.
None at one rank."""


def read(rec):
    ex = rec.get("exchange")
    return sum(c for c, _ in ex) / len(ex) if ex else None
