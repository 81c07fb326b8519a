"""device_mem_gib: the program's peak device memory over set-up and window
(torch.cuda.max_memory_allocated), less what the benchmark's staged inputs
hold, in GiB."""


def read(rec):
    return rec["device_mem_bytes"] / 2 ** 30
