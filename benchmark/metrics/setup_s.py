"""setup_s: seconds from the process's start to the window's start (loading,
weights, the pool, building the kernels, recording the graphs)."""


def read(rec):
    return rec["setup_s"]
