"""batched.step_ms.replay: device ms of a batched step, by CUDA events
around the steps of the window that run before the profiler starts (the
traced run's untraced part), their total over their count."""


def read(rec):
    return rec.get("untraced_ms")
