"""peak_mem_gib (GiB, end to end): torch.cuda.max_memory_allocated over
set-up and window, the largest of the ranks (None off the card)."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["on_card"] else None
