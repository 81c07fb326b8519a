"""setup_s: process start to the first timed call, host clock."""


def read(rec):
    return rec["setup_s"]
