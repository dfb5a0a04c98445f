"""The port's generated notebooks against the JAX package's, on the CPU
(counterpart of ``tests/test_notebook_exec.py``, which runs the JAX
notebook in a jupyter kernel).

One notebook of all 15 analysis templates is generated by each
package's ``notebook_for`` over the same seeded raw file, and its code
cells are run in this process, each package's in a namespace of its
own (magics dropped; the plots drawn with matplotlib's Agg backend and
closed).  The port's cells open ``Context.make_with("sharded")``, which
is every CUDA card: the test maps the port's default device to the CPU,
as its other tests do.  Each analysis's ``result``: channels, titles
and raw results within rtol 1e-5 of the JAX notebook's (float32 sums
in other orders, absolute floor 1e-5 of the largest magnitude); the
CLUST labels equal.
"""
import numpy as np
import pytest
import torch

from libertem_tpu.web import notebook_generator as jax_nb

import libertem_tpu_torch.executor.base as port_executor_base
from libertem_tpu_torch.web import notebook_generator as port_nb

torch.set_num_threads(1)

RTOL = 1e-5
ALL_IDS = (
    "SUM_FRAMES", "SD_FRAMES", "SUM_SIG", "PICK_FRAME",
    "APPLY_DISK_MASK", "APPLY_RING_MASK", "APPLY_POINT_SELECTOR",
    "MASKS", "CENTER_OF_MASS", "RADIAL_FOURIER", "FEM", "CLUST",
    "APPLY_FFT_MASK", "PICK_FFT_FRAME", "FFTSUM_FRAMES",
)
PARAMS = {
    "cx": 4, "cy": 4, "r": 3, "ri": 1, "ro": 4, "x": 1, "y": 1,
    "n_bins": 2, "max_order": 2, "flip_y": False,
    "scan_rotation": 0.0, "rad_in": 1, "rad_out": 4, "n_clust": 3,
    "n_peaks": 5,
}


def _notebook(nb_mod, raw_path):
    return nb_mod.notebook_for(
        "RAW", {"path": raw_path, "dtype": "float32",
                "nav_shape": [4, 4], "sig_shape": [8, 8]},
        [{"analysisType": i, "parameters": dict(PARAMS)} for i in ALL_IDS])


def _run_cells(nb):
    """Each code cell in one namespace, magics dropped; the ``result``
    after each analysis cell, in the order of ALL_IDS."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ns: dict = {}
    results = []
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    for i, cell in enumerate(cells):
        src = "".join(line for line in cell["source"]
                      if not line.lstrip().startswith("%"))
        exec(compile(src, f"<cell {i}>", "exec"), ns)
        if i >= 3:  # dependency, ctx and dataset cells first
            results.append(ns.pop("result"))
        plt.close("all")
    return ns, results


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    data = np.random.default_rng(42).normal(size=(4, 4, 8, 8)).astype(
        np.float32)
    raw_path = str(tmp_path_factory.mktemp("nb") / "nb-exec.raw")
    data.tofile(raw_path)
    jnb = _notebook(jax_nb, raw_path)
    pnb = _notebook(port_nb, raw_path)
    _, jres = _run_cells(jnb)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_executor_base, "resolve_device",
               lambda d=None: torch.device("cpu"))
    try:
        pns, pres = _run_cells(pnb)
    finally:
        mp.undo()
    return {"data": data, "jax_nb": jnb, "port_nb": pnb,
            "jax": dict(zip(ALL_IDS, jres)),
            "port": dict(zip(ALL_IDS, pres)), "port_ns": pns}


def test_port_notebook_imports_the_port(executed):
    src = "".join("".join(c["source"]) for c in executed["port_nb"]["cells"])
    assert "from libertem_tpu_torch import Context" in src
    assert 'Context.make_with("sharded")' in src
    assert "libertem_tpu." not in src.replace("libertem_tpu_torch", "")
    # the same notebook as the JAX package's, but for the package name
    jsrc = "".join("".join(c["source"])
                   for c in executed["jax_nb"]["cells"])
    assert src.replace("libertem_tpu_torch", "libertem_tpu") == jsrc
    ctx = executed["port_ns"]["ctx"]
    assert type(ctx).__module__ == "libertem_tpu_torch.api"
    assert ctx.executor.devices == [torch.device("cpu")]


@pytest.mark.parametrize("id_", ALL_IDS)
def test_notebook_result_like_jax(executed, id_):
    if id_ == "CLUST":
        pytest.importorskip("sklearn")
    j, p = executed["jax"][id_], executed["port"][id_]
    assert [r.key for r in p] == [r.key for r in j]
    assert len(p) > 0
    for rj, rp in zip(j, p):
        assert (rp.title, rp.desc) == (rj.title, rj.desc), rp.key
        got, want = np.asarray(rp.raw_data), np.asarray(rj.raw_data)
        assert got.shape == want.shape, rp.key
        if id_ == "CLUST" or want.dtype.kind in "iub":
            assert np.array_equal(got, want), rp.key
            continue
        finite = np.abs(want[np.isfinite(want)])
        scale = float(finite.max()) if finite.size else 0.0
        assert np.allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                           equal_nan=True), (
            rp.key, float(np.nanmax(np.abs(got - want))))


def test_notebook_sum_against_numpy(executed):
    data = executed["data"].astype(np.float64)
    res = executed["port"]["SUM_FRAMES"]
    got = res.intensity.raw_data
    assert np.allclose(got, data.sum(axis=(0, 1)), rtol=RTOL,
                       atol=RTOL * np.abs(data.sum(axis=(0, 1))).max())


def test_copy_notebook_sections_like_jax():
    conn = {"connection": {"type": "local"}}
    params = {"path": "/t.raw", "dtype": "float32", "nav_shape": [4, 4],
              "sig_shape": [8, 8]}
    analyses = [{"analysisType": i, "parameters": dict(PARAMS)}
                for i in ("SUM_FRAMES", "CENTER_OF_MASS", "CLUST")]
    j = jax_nb.copy_notebook(conn, "RAW", params, analyses)
    p = port_nb.copy_notebook(conn, "RAW", params, analyses)
    assert set(p) == set(j) == {"dependency", "initial_setup", "ctx",
                                "dataset", "analysis"}
    norm = repr(p).replace("libertem_tpu_torch", "libertem_tpu")
    assert norm == repr(j)
    assert p["initial_setup"] == "%matplotlib inline\n"
    nb = port_nb.notebook_for("RAW", params, analyses)
    assert port_nb.notebook_to_bytes(nb) == \
        jax_nb.notebook_to_bytes(jax_nb.notebook_for(
            "RAW", params, analyses)).replace(
            b"libertem_tpu", b"libertem_tpu_torch")


def test_generator_helper_templates_import_the_port():
    helper = port_nb.GeneratorHelper({"cx": 1})
    helper.short_name, helper.api = "sum", "create_sum_analysis"
    assert helper.get_analysis() == (
        "sum_analysis = ctx.create_sum_analysis()\n"
        "sum_result = ctx.run(sum_analysis, progress=True)")
    assert "import libertem_tpu_torch.api as lt" in \
        port_nb.TemplateBase.temp_dep
    assert port_nb.TemplateBase().format_template(
        port_nb.TemplateBase.temp_dep_ds, {"backend_cls": "MMapBackend"}) \
        == "from libertem_tpu_torch.io.dataset.base import MMapBackend"
