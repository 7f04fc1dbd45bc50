"""datasets, utils/plots.py and utils/profiling.py of gpyrn_tpu_torch
against gpyrn_tpu.

* ``load_solar`` and ``solar_observations`` return the JAX loaders'
  arrays exactly, from the port's own copy of ``Solar_observations.txt``,
  which is byte-equal to the JAX package's;
* ``plot_prediction``, ``plot_structure`` and ``plot_elbo_history``
  (matplotlib's Agg backend) draw the JAX package's figures: the same
  axes, the same lines (x exactly, y to rtol 1e-9, the predictions of
  the same state by both packages) and the same texts;
* the package imports with matplotlib blocked;
* ``StageTimer`` keeps the JAX API, and ``trace()`` writes a trace of the
  enclosed block on the CPU."""
import glob
import json
import os
import subprocess
import sys
import textwrap

import matplotlib
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu import datasets as jd
from gpyrn_tpu.utils import plots as jplots
from gpyrn_tpu_torch import datasets as td
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.utils import plots as tplots
from gpyrn_tpu_torch.utils.profiling import StageTimer, trace

matplotlib.use("Agg")
torch.set_num_threads(1)

LINE_RTOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_solar_loaders_match_jax():
    assert td.SOLAR_COLUMNS == jd.SOLAR_COLUMNS
    got, ref = td.solar_observations(), jd.solar_observations()
    assert list(got) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name])
    for outputs, subtract in ((("RV", "FWHM"), True), (("BIS",), False)):
        (t_got, d_got), (t_ref, d_ref) = (td.load_solar(outputs, subtract),
                                          jd.load_solar(outputs, subtract))
        np.testing.assert_array_equal(t_got, t_ref)
        assert len(d_got) == len(d_ref) == 2 * len(outputs)
        for a, b in zip(d_got, d_ref):
            np.testing.assert_array_equal(a, b)
    assert t_got.shape == (497,)


def test_dataset_file_is_the_jax_packages():
    name = "Solar_observations.txt"
    with open(os.path.join(os.path.dirname(td.__file__), name), "rb") as f:
        got = f.read()
    with open(os.path.join(os.path.dirname(jd.__file__), name), "rb") as f:
        ref = f.read()
    assert got == ref


@pytest.fixture(scope="module")
def models():
    time, data = jd.load_solar(("RV", "FWHM"))
    keep = slice(0, 200, 10)
    time, data = time[keep], [d[keep] for d in data]
    g = gj.inference(1, time, *data)
    g.set_components(gj.covfunc.QuasiPeriodic(1.0, 30.0, 27.0, 0.7),
                     [gj.covfunc.SquaredExponential(2.0, 30.0),
                      gj.covfunc.SquaredExponential(2.2, 30.0)],
                     [gj.meanfunc.Keplerian(100.0, 1.0, 0.1, 0.5, 0.0),
                      gj.meanfunc.Constant(0.0)], [1.0, 1.1])
    mu, var = g.engine.init_mu_var(g._theta(), g.y)
    g._mu, g._var = np.asarray(mu), np.asarray(var)
    return g, inference_from_jax(g, device="cpu")


def _same_figure(fig_t, fig_j):
    import matplotlib.pyplot as plt
    assert len(fig_t.axes) == len(fig_j.axes)
    for ax_t, ax_j in zip(fig_t.axes, fig_j.axes):
        lines_t, lines_j = ax_t.get_lines(), ax_j.get_lines()
        assert len(lines_t) == len(lines_j)
        for a, b in zip(lines_t, lines_j):
            np.testing.assert_array_equal(a.get_xdata(), b.get_xdata())
            np.testing.assert_allclose(np.asarray(a.get_ydata(), float),
                                       np.asarray(b.get_ydata(), float),
                                       rtol=LINE_RTOL, atol=1e-12)
        assert [t.get_text() for t in ax_t.texts] == \
            [t.get_text() for t in ax_j.texts]
        assert ax_t.get_title(loc="right") == ax_j.get_title(loc="right")
    plt.close(fig_t)
    plt.close(fig_j)


def test_plot_prediction_draws_the_jax_figure(models):
    g_jax, g = models
    fig_t, axs_t = g.plot_prediction(nn=40, title="solar")
    fig_j, axs_j = jplots.plot_prediction(g_jax, nn=40, title="solar")
    assert sorted(axs_t) == sorted(axs_j)
    _same_figure(fig_t, fig_j)


def test_plot_structure_and_history_draw_the_jax_figures(models):
    g_jax, g = models
    fig_t, _ = g.plot_structure(title="GPRN")
    fig_j, _ = jplots.plot_structure(g_jax, title="GPRN")
    _same_figure(fig_t, fig_j)
    elbos = np.linspace(-30.0, -20.0, 7)
    ax_t = tplots.plot_elbo_history(torch.tensor(elbos))
    ax_j = jplots.plot_elbo_history(elbos)
    _same_figure(ax_t.figure, ax_j.figure)


def test_package_imports_without_matplotlib():
    code = textwrap.dedent("""
        import sys
        sys.modules["matplotlib"] = None
        sys.modules["jax"] = None
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        import gpyrn_tpu_torch as gt
        from gpyrn_tpu_torch import datasets, serving
        from gpyrn_tpu_torch.utils import astro, plots, profiling
        t, data = datasets.load_solar()
        g = gt.inference(1, t, *data, device="cpu")
        se = gt.covfunc.SquaredExponential(1.0, 30.0)
        g.set_components(se, [se, se], None, [0.1, 0.1])
        try:
            g.plot_structure()
        except ImportError:
            print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_stage_timer_keeps_the_jax_api():
    timer = StageTimer()
    x = torch.ones(3)
    for _ in range(2):
        with timer.stage("fit", block_on=x):
            x = x + 1
    with timer.stage("predict", block_on=(x, x)):
        pass
    summary = timer.summary()
    assert list(summary) == ["fit", "predict"]
    assert summary["fit"]["n"] == 2 and summary["fit"]["total_s"] >= 0
    assert set(summary["fit"]) == {"n", "total_s", "mean_ms", "last_ms"}
    lines = timer.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("fit")


def test_trace_writes_a_trace_of_the_block(tmp_path):
    a = torch.ones(16, 16, dtype=torch.float64)
    with trace(str(tmp_path)) as prof:
        torch.mm(a, a)
    assert prof is not None
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
