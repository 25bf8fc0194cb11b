"""Aux subsystems: profiling hooks, multihost helpers, templates."""

import os

import jax
import pytest

from raisin_jax.utils.profiling import StageTimer, trace
from raisin_jax.parallel import multihost


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    rep = t.report()
    assert set(rep) == {"a", "b"}
    assert all(v >= 0 for v in rep.values())


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        jax.numpy.ones(8).block_until_ready()
    assert os.path.isdir(d)
    found = any(files for _, _, files in os.walk(d))
    assert found, "profiler trace produced no files"


def test_multihost_helpers_single_process():
    # single-process semantics: the whole block range, data mesh over 8 CPUs
    lo, hi = multihost.process_block_range(10)
    assert (lo, hi) == (0, 10)
    mesh = multihost.global_data_mesh(model_axis=2)
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        multihost.global_data_mesh(model_axis=3)


def test_benchmark_html_page():
    from raisin_jax.engine.templates import render_benchmark_page

    html = render_benchmark_page("<table>x</table>", created=123)
    assert "<table>x</table>" in html and 'data-created="123"' in html
