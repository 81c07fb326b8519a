"""replay_scans_per_s: every scan fused in the window over the window's
time, host clock, the window ending in torch.cuda.synchronize()."""


def read(rec):
    return rec["scans"] / rec["window_s"] if rec["loop"] == "replay" else None
