"""setup_s (s, end to end): from the process's start to the first timed
step: imports, the kernels' build or load, the sample, the cold step with
its capacity retries and the warm steps (for several ranks, from the
launching process's start, with the ranks' start and the NCCL group)."""


def read(rec):
    return rec["setup_s"]
