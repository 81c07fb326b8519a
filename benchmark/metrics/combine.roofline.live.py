"""combine.roofline.live: K4 in the traced maps, its bound over its device
time, in %. Nothing where the trace lost a K4 launch."""


def read(rec):
    t, bounds = rec.get("trace"), rec.get("bounds")
    if not t or "combine" not in (bounds or {}):
        return None
    g = t["groups"]["combine"]
    return 100.0 * bounds["combine"] * 1e-3 / g["seconds"] if g["complete"] and g["seconds"] > 0 else None
