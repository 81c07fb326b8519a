"""The port's NumPy oracle, its parity helper and `cli parity` against the JAX
package's, on the CPU.

gvom_tpu_torch.oracle is the JAX package's oracle with the port's config and
the port's ray geometry (the geometry both engines share, computed in
PyTorch): over the same scans every map it makes is bitwise the JAX
oracle's. singular_fit_mask is the same function. `cli parity --device cpu`
prints the same report, field for field, as the JAX package's `cli parity
--cpu`: the port's engine agrees with the oracle exactly as far as the JAX
engine does (rough_max_diff_defined included, since the port's roughness is
bitwise the JAX package's)."""

import contextlib
import io
import json

import numpy as np
import pytest

from gvom_tpu import cli as jcli
from gvom_tpu.io import synthetic
from gvom_tpu.oracle import NumpyOracle as JaxOracle
from gvom_tpu.utils.parity import singular_fit_mask as jax_singular_fit_mask

from gvom_tpu_torch import cli as tcli
from gvom_tpu_torch.oracle import NumpyOracle
from gvom_tpu_torch.utils.parity import singular_fit_mask

from conftest import make_scan
from torch_helpers import EGOS, tcfg

MAPS = ("height_map", "inferred_height_map", "roughness_map", "x_slope_map", "y_slope_map", "guessed_height_delta",
        "positive_obstacle", "eigenvalues")
COMBINED = ("origin", "hit", "passes", "min_height", "n", "mean", "cov", "evidence")
EXPORTERS = ("get_map_as_occupancy_grid", "make_debug_voxel_map", "make_debug_height_map",
             "make_debug_inferred_height_map")


@pytest.fixture(scope="module")
def oracles(small_cfg):
    """Both oracles after each of 3 scans with a moving ego: (port, jax,
    [(port outputs, jax outputs)] of every combine)."""
    port, ref = NumpyOracle(tcfg(small_cfg)), JaxOracle(small_cfg)
    outs = []
    for i, ego in enumerate(EGOS[:3]):
        pts = make_scan(synthetic.composite_terrain(), ego, seed=i, cfg=small_cfg)
        for o in (port, ref):
            o.process_pointcloud(pts, ego)
        outs.append((port.combine_maps(), ref.combine_maps()))
    return port, ref, outs


def test_oracle_combine_outputs_bitwise(oracles):
    _, _, outs = oracles
    for i, (a, b) in enumerate(outs):
        assert len(a) == len(b) == 5
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"combine {i}: output {k}")
            assert np.asarray(x).dtype == np.asarray(y).dtype


def test_oracle_maps_and_exporters_bitwise(oracles):
    port, ref, _ = oracles
    for name in MAPS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in COMBINED:
        np.testing.assert_array_equal(getattr(port.combined, name), getattr(ref.combined, name), err_msg=name)
    for name in EXPORTERS:
        np.testing.assert_array_equal(getattr(port, name)(), getattr(ref, name)(), err_msg=name)
    assert (port.height_map > -1000).sum() > 500


def test_singular_fit_mask_matches(oracles, small_cfg):
    port, _, _ = oracles
    rng = np.random.default_rng(3)
    random_hm = np.where(rng.random((64, 64)) < 0.5, rng.normal(size=(64, 64)), -1000.0)
    for hm in (port.height_map, random_hm):
        got = singular_fit_mask(hm, small_cfg.xy_resolution)
        np.testing.assert_array_equal(got, jax_singular_fit_mask(hm, small_cfg.xy_resolution))
        assert got.any() and not got.all()


def _report(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) in (None, 0)
    return json.loads(out.getvalue())


def test_cli_parity_report_equals_the_jax_packages():
    port = _report(tcli.main, ["parity", "--device", "cpu", "--scans", "3"])
    ref = _report(jcli.main, ["parity", "--cpu", "--scans", "3"])
    assert port["config"] == ref["config"] == {"grid": 64, "scans": 3}
    assert len(port["per_combine"]) == len(ref["per_combine"]) == 3
    for i, (a, b) in enumerate(zip(port["per_combine"], ref["per_combine"])):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k] == b[k], f"combine {i}: {k} {a[k]} != {b[k]}"
    assert all(r["vis_equal"] and r["neg_equal"] for r in port["per_combine"])
