"""raycast.roofline.replay: K1 in the traced steps, its bound over its
device time, in %. Nothing where the trace lost a K1 launch."""


def read(rec):
    t, bounds = rec.get("trace"), rec.get("bounds")
    if not t or "raycast" not in (bounds or {}):
        return None
    g = t["groups"]["raycast"]
    return 100.0 * bounds["raycast"] * 1e-3 / g["seconds"] if g["complete"] and g["seconds"] > 0 else None
