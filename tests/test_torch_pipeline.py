"""The port's ring buffer after several scans (gvom_tpu_torch.models.pipeline
ingest_and_insert, in place) against gvom_tpu's, on the CPU, including an
empty scan and a scan whose points all fall inside min_distance: both are
degenerate and land in the write-off slot B."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvom_tpu.models import pipeline as jpipeline
from gvom_tpu.types import empty_buffer_state as jempty_buffer

from gvom_tpu_torch.models import pipeline as tpipeline
from gvom_tpu_torch.types import empty_buffer_state

from torch_helpers import EGOS, assert_state_equal, convert, jax_ingest, jax_numpy, scan, t, tcfg

KINDS = ["normal", "normal", "empty", "near", "normal", "normal"]


@pytest.fixture(scope="module")
def drive(small_cfg):
    cfg = small_cfg
    c = tcfg(cfg)
    ingest = jax_ingest(cfg)
    jbuf = jempty_buffer(cfg)
    tbuf = empty_buffer_state(c, "cpu")
    states = []
    for i, kind in enumerate(KINDS):
        ego = EGOS[i % len(EGOS)] + np.array([0.0, 0.0, 0.01 * i])
        pad, mask = scan(cfg, i, ego, kind)
        e = np.float32(ego)
        jbuf, jok = ingest(jbuf, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
        _, tok = tpipeline.ingest_and_insert(c, tbuf, t(pad), t(mask), t(e))
        states.append((kind, bool(jok), bool(tok),
                       convert.logical_from_jax_numpy(jax_numpy(jbuf)), convert.to_numpy(tbuf)))
    return states


@pytest.mark.parametrize("step", range(len(KINDS)))
def test_buffer_state_after_each_scan(drive, step):
    kind, jok, tok, ref, port = drive[step]
    assert jok == tok == (kind == "normal")
    assert_state_equal(port, ref, f"scan {step} ({kind})")


def test_buffer_insert_matches_jax(small_cfg):
    """buffer_insert writes an already voxelized scan into the cursor slot,
    or into the write-off slot B when the scan is degenerate, as gvom_tpu's
    does: the grids are gvom_tpu's ingest_scan outputs, carried over."""
    cfg = small_cfg
    c = tcfg(cfg)
    jins = jax.jit(lambda b, p, v, e: jpipeline.buffer_insert(cfg, b, *jpipeline.ingest_scan(cfg, p, v, e)))
    jbuf = jempty_buffer(cfg)
    tbuf = empty_buffer_state(c, "cpu")
    for i, kind in enumerate(["normal", "empty", "normal", "near", "normal"]):
        pad, mask = scan(cfg, i, EGOS[i], kind)
        args = (jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(np.float32(EGOS[i])))
        grid, ok = jax.jit(lambda *a: jpipeline.ingest_scan(cfg, *a))(*args)
        jbuf = jins(jbuf, *args)
        tpipeline.buffer_insert(c, tbuf, convert.from_jax_numpy(jax_numpy(grid), "cpu"), t(np.asarray(ok)))
        assert bool(ok) == (kind == "normal")
        ref, port = convert.logical_from_jax_numpy(jax_numpy(jbuf)), convert.to_numpy(tbuf)
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=f"scan {i} ({kind}): {k}")


def test_full_step_equals_ingest_then_combine(small_cfg):
    """full_step is ingest_and_insert then combine, and its ok flag is
    combine_ok."""
    from gvom_tpu_torch.types import empty_world_state

    c = tcfg(small_cfg)
    a, b = empty_buffer_state(c, "cpu"), empty_buffer_state(c, "cpu")
    wa, wb = empty_world_state(c, "cpu"), empty_world_state(c, "cpu")
    for i, kind in enumerate(["normal", "empty", "normal"]):
        pad, mask = scan(small_cfg, i, EGOS[i], kind)
        e = t(np.float32(EGOS[i]))
        _, wa, pa, oka = tpipeline.full_step(c, a, wa, t(pad), t(mask), e)
        tpipeline.ingest_and_insert(c, b, t(pad), t(mask), e)
        wb, pb, okb = tpipeline.combine(c, b, wb, e)
        assert bool(oka) == bool(okb) is True
        for k in ("height", "positive_obstacle", "roughness", "guessed_height_delta"):
            np.testing.assert_array_equal(getattr(pa, k).numpy(), getattr(pb, k).numpy(), err_msg=k)
    sa, sb = convert.to_numpy(wa), convert.to_numpy(wb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
