"""peak_mem_gib: the program's ``torch.cuda.max_memory_reserved`` from the
start through the window, read before the reference runs, in GiB."""


def read(rec):
    return rec["peak_reserved"] / 2 ** 30 if rec["peak_reserved"] else None
