"""step_rate (particles/s, end to end): the particles a chip holds times
the steps completed in the window, over the window's seconds."""


def read(rec):
    return rec["n_per_chip"] * rec["steps"] / rec["window_s"]
