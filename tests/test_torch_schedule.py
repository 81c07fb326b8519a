"""The JAX package's schedule property (tests/test_schedule_property.py)
through the port on the CPU: hypothesis draws schedules of ingests from two
sensors and combines; the port's Gvom facade and the JAX facade run each one
and give the same outputs after every combine_maps (None before the first
ingest), and the port's world keeps the encoding's invariants (occupied
voxels carry no negative evidence, counters are non-negative, min_height is
a real minimum where hit and the sentinel 1.0 elsewhere)."""

import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gvom_tpu_torch
from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic

from torch_helpers import jax_facade, tcfg

_CFG = GvomConfig(xy_size=32, z_size=16, max_points=2048, buffer_size=3)

# a small pool of scans from two sensors at offset poses
_SCANS = []
for s in range(2):
    _ego = np.array([0.3 + 0.5 * s, -0.2 + 0.3 * s, 1.5])
    for i in range(3):
        _ego = _ego + np.array([0.4, 0.2, 0.0])
        _pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), _ego, channels=8, azimuth_steps=24,
                                             max_range=10.0, seed=10 * s + i)
        _SCANS.append((synthetic.nudge_off_grid(_pts, _CFG.xy_resolution, _CFG.z_resolution), _ego.copy()))

# an op indexes _SCANS; -1 is combine_maps
_ops = st.lists(st.integers(min_value=-1, max_value=len(_SCANS) - 1), min_size=2, max_size=8)


@settings(max_examples=6, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_ops)
def test_schedule_port_equals_jax(schedule):
    jg, tg = jax_facade(_CFG), gvom_tpu_torch.Gvom(config=tcfg(_CFG), device="cpu")
    for k, op in enumerate(schedule):
        if op >= 0:
            pts, ego = _SCANS[op]
            jok, tok = jg.process_pointcloud(pts, ego), tg.process_pointcloud(pts, ego)
            assert bool(jok) == bool(tok)
            continue
        ref, out = jg.combine_maps(), tg.combine_maps()
        if ref is None or out is None:
            assert ref is None and out is None, f"op {k}: one facade combined before any ingest"
            continue
        for name, a, b in zip(("origin", "positive", "negative", "roughness", "visibility"), out, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"op {k} of {schedule}: {name}")

    w = tg.world_state
    hit, ev, miss = w.grid.hit.numpy(), w.evidence.numpy(), w.grid.miss.numpy()
    assert (hit >= 0).all() and (miss >= 0).all() and (ev >= 0).all()
    if bool(w.valid):
        assert (ev[hit > 0] == 0).all()
    mh = w.grid.min_height.numpy()
    assert (mh[hit > 0] < 1.0 + 1e-6).all()
    assert (mh[hit == 0] == 1.0).all()
