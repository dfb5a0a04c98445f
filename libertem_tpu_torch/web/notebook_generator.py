"""Jupyter notebook generation (counterpart of
``libertem_tpu/web/notebook_generator.py``): every GUI analysis can be
exported as runnable notebook code, downloaded as .ipynb or copied as
code sections.  The generated cells import ``libertem_tpu_torch``, and
their ``Context.make_with("sharded")`` runs on every visible CUDA
card.
"""
from __future__ import annotations

import json
from typing import Sequence


def _code_cell(source: str) -> dict:
    return {
        "cell_type": "code",
        "execution_count": None,
        "metadata": {},
        "outputs": [],
        "source": source.splitlines(keepends=True),
    }


def _md_cell(source: str) -> dict:
    return {
        "cell_type": "markdown",
        "metadata": {},
        "source": source.splitlines(keepends=True),
    }


# analysisType -> (title, analysis code template, plot code lines),
# templates use {params} placeholders.  Analysis and plot parts are
# kept separate so the GUI 'copy code' endpoint can hand them out as
# sections.
ANALYSIS_TEMPLATES = {
    "SUM_FRAMES": (
        "Sum of all frames",
        "analysis = ctx.create_sum_analysis(dataset=ds)\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "SUM_SIG": (
        "Sum over the detector",
        "analysis = ctx.create_sumsig_analysis(dataset=ds)\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "SD_FRAMES": (
        "Standard deviation",
        "analysis = ctx.create_sd_analysis(dataset=ds)\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.std.raw_data)\n"],
    ),
    "APPLY_DISK_MASK": (
        "Disk (bright field) virtual detector",
        "analysis = ctx.create_disk_analysis(dataset=ds, "
        "cx={cx}, cy={cy}, r={r})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "APPLY_RING_MASK": (
        "Ring (dark field) virtual detector",
        "analysis = ctx.create_ring_analysis(dataset=ds, "
        "cx={cx}, cy={cy}, ri={ri}, ro={ro})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "APPLY_POINT_SELECTOR": (
        "Point selector",
        "analysis = ctx.create_point_analysis(dataset=ds, "
        "x={cx}, y={cy})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "CENTER_OF_MASS": (
        "Center of mass",
        "analysis = ctx.create_com_analysis(dataset=ds, "
        "cx={cx}, cy={cy}, mask_radius={r}, "
        "mask_radius_inner={ri}, flip_y={flip_y}, "
        "scan_rotation={scan_rotation})\n"
        "result = ctx.run(analysis)\n",
        ["fig, axes = plt.subplots(1, 3, figsize=(12, 4))\n"
         "axes[0].imshow(result.magnitude.raw_data)\n"
         "axes[1].imshow(result.divergence.raw_data)\n"
         "axes[2].imshow(result.curl.raw_data)\n"],
    ),
    "RADIAL_FOURIER": (
        "Radial Fourier series",
        "analysis = ctx.create_radial_fourier_analysis(dataset=ds, "
        "cx={cx}, cy={cy}, ri={ri}, ro={ro}, n_bins={n_bins}, "
        "max_order={max_order})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.dominant_0.raw_data)\n"],
    ),
    "PICK_FRAME": (
        "Pick a single frame",
        "analysis = ctx.create_pick_analysis(dataset=ds, "
        "x={x}, y={y})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "FEM": (
        "Fluctuation EM",
        "analysis = ctx.create_fem_analysis(dataset=ds, "
        "cx={cx}, cy={cy}, ri={ri}, ro={ro})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "MASKS": (
        "Custom mask stack",
        # MASKS parameters hold callables (factories) that can't
        # ride a generated notebook — emit an editable placeholder
        # that always runs
        "# EDIT: define your mask factories here\n"
        "factories = [lambda: np.ones(tuple(ds.shape.sig), "
        "dtype='float32')]\n"
        "analysis = ctx.create_mask_analysis(dataset=ds, "
        "factories=factories)\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.mask_0.raw_data)\n"],
    ),
    "APPLY_FFT_MASK": (
        "FFT ring mask",
        "from libertem_tpu_torch.analysis import ApplyFFTMask\n"
        "analysis = ApplyFFTMask(dataset=ds, parameters=dict("
        "rad_in={rad_in}, rad_out={rad_out}))\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "PICK_FFT_FRAME": (
        "FFT of a single frame",
        "from libertem_tpu_torch.analysis import PickFFTFrameAnalysis\n"
        "analysis = PickFFTFrameAnalysis(dataset=ds, "
        "parameters=dict(x={x}, y={y}))\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "FFTSUM_FRAMES": (
        "FFT of the sum of all frames",
        "from libertem_tpu_torch.analysis import SumfftAnalysis\n"
        "analysis = SumfftAnalysis(dataset=ds, parameters={{}})\n"
        "result = ctx.run(analysis)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
    "CLUST": (
        "Clustering",
        "from libertem_tpu_torch.analysis import ClusterAnalysis\n"
        "analysis = ClusterAnalysis(dataset=ds, parameters=dict("
        "n_clust={n_clust}, n_peaks={n_peaks}))\n"
        "result = analysis.run_clustering(ctx)\n",
        ["plt.figure()\n"
         "plt.imshow(result.intensity.raw_data)\n"],
    ),
}


class _Defaults(dict):
    def __missing__(self, key):
        return "None"


def dependency_cell() -> str:
    return (
        "import matplotlib.pyplot as plt\n"
        "import numpy as np\n"
    )


def initial_setup_cell() -> str:
    return "%matplotlib inline\n"


def ctx_cell() -> str:
    return (
        "from libertem_tpu_torch import Context\n"
        'ctx = Context.make_with("sharded")\n'
    )


def dataset_cell(ds_type: str, ds_params: dict) -> str:
    args = ", ".join(
        f"{k}={v!r}" for k, v in ds_params.items()
        if k not in ("type",) and v is not None
    )
    return f'ds = ctx.load("{ds_type.lower()}", {args})\n'


class TemplateBase:
    """Shared code-template strings and substitution helper of the
    notebook GeneratorHelper subclasses (the JAX package's attribute
    names, with the port's imports)."""

    temp_ds_backend = ["io_backend = ${backend_cls}()"]
    temp_ds = [
        "params = $params",
        'ds = ctx.load("$type", **params)',
    ]
    temp_dep_ds = [
        "from libertem_tpu_torch.io.dataset.base import ${backend_cls}",
    ]
    temp_dep = [
        "import matplotlib.pyplot as plt",
        "import libertem_tpu_torch.api as lt",
        "import numpy as np",
    ]
    temp_dep_conn = []  # no dask cluster: the executor is local
    temp_conn = ["ctx = lt.Context()"]
    temp_analysis = [
        "${short}_analysis = ctx.$analysis_api($params)",
        "${short}_result = ctx.run(${short}_analysis, "
        "progress=True)",
    ]
    temp_save = [
        "np.save('${short}_result.npy', "
        "${short}_result['intensity'])",
    ]

    def code_formatter(self, code):
        try:
            import autopep8
            return autopep8.fix_code(code)
        except ImportError:
            return code

    def format_template(self, template, data):
        from string import Template

        return Template("\n".join(template)).substitute(data)


class GeneratorHelper(TemplateBase):
    """Extension point of the notebook generation: an Analysis class
    that has a ``get_template_helper()`` returning a subclass gets its
    docs/dependency/analysis/plot/save cells instead of the built-in
    template table."""

    short_name = None
    api = None

    def __init__(self, params):
        self.params = params

    def get_dependency(self):
        return None

    def convert_params(self):
        return None

    def get_plot(self):
        return None

    def get_docs(self):
        return None

    def get_analysis(self):
        data = {
            "short": self.short_name,
            "analysis_api": self.api,
            "params": self.convert_params() or "",
        }
        return self.format_template(self.temp_analysis, data)

    def get_save(self):
        return self.format_template(
            self.temp_save, {"short": self.short_name}
        )

    def format_docs(self, title, docs_rst):
        return f"# {title}\n\n<pre>{docs_rst}</pre>"


def _helper_section(helper_cls, a_type: str, params: dict):
    """Build one analysis section from a registered
    GeneratorHelper subclass."""
    helper = helper_cls(params)
    plot = helper.get_plot() or []
    if isinstance(plot, str):
        plot = [plot]
    section = {
        "title": helper.short_name or a_type,
        "analysis": helper.get_analysis(),
        "plot": list(plot),
    }
    save = helper.get_save()
    if save:
        section["save"] = save
    docs = helper.get_docs()
    if docs:
        section["docs"] = docs
    dep = helper.get_dependency()
    if dep:
        section["dependency"] = list(dep)
    return section


def analysis_sections(analyses: Sequence[dict]) -> list:
    """[{title, analysis, plot: [...]}] per GUI analysis entry."""
    from ..analysis.base import Analysis

    out = []
    for entry in analyses:
        a_type = entry["analysisType"]
        params = dict(entry.get("parameters", {}))
        helper_cls = None
        try:
            cls = Analysis.get_analysis_by_type(a_type)
            helper_cls = cls.get_template_helper()
        except Exception:
            helper_cls = None
        if helper_cls is not None:
            out.append(_helper_section(helper_cls, a_type, params))
            continue
        tpl = ANALYSIS_TEMPLATES.get(a_type)
        if params.get("roi"):
            # the pretty create_* templates can't express a GUI roi —
            # the registry form reproduces the GUI result exactly
            # (ctx.run picks the roi up via analysis.get_roi())
            tpl = None
        if tpl is None:
            # generic fallback: any registered analysis runs through
            # the registry (covers FFT / cluster / custom analyses)
            out.append({
                "title": a_type,
                "analysis": (
                    "from libertem_tpu_torch.analysis import Analysis\n"
                    "cls = Analysis.get_analysis_by_type("
                    f"{a_type!r})\n"
                    f"analysis = cls(dataset=ds, "
                    f"parameters={params!r})\n"
                    "result = ctx.run(analysis)\n"
                ),
                "plot": [
                    "for r in result:\n"
                    "    plt.figure()\n"
                    "    plt.title(r.title)\n"
                    "    plt.imshow(np.asarray(r.visualized))\n"
                ],
            })
            continue
        title, analysis_code, plot_lines = tpl
        defaults = _Defaults(**params)
        out.append({
            "title": title,
            "analysis": analysis_code.format_map(defaults),
            "plot": [
                p.format_map(defaults) for p in plot_lines
            ],
        })
    return out


def copy_notebook(conn: dict, ds_type: str, ds_params: dict,
                  analyses: Sequence[dict]) -> dict:
    """Code sections for the GUI 'copy code' button."""
    return {
        "dependency": dependency_cell(),
        "initial_setup": initial_setup_cell(),
        "ctx": ctx_cell(),
        "dataset": dataset_cell(ds_type, ds_params),
        "analysis": [
            {"analysis": sec["analysis"], "plot": sec["plot"]}
            for sec in analysis_sections(analyses)
        ],
    }


def notebook_for(
    ds_type: str,
    ds_params: dict,
    analyses: Sequence[dict],
) -> dict:
    """Build the notebook JSON for a dataset + list of
    {analysisType, parameters} entries."""
    cells = [
        _md_cell("# libertem_tpu_torch analysis notebook\n"
                 "Generated from the web GUI."),
        _code_cell(dependency_cell()),
        _code_cell(ctx_cell()),
        _code_cell(dataset_cell(ds_type, ds_params)),
    ]
    for sec in analysis_sections(analyses):
        cells.append(_md_cell(f"## {sec['title']}"))
        cells.append(_code_cell(
            sec["analysis"] + "".join(sec["plot"])
        ))
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {
                "display_name": "Python 3",
                "language": "python",
                "name": "python3",
            },
        },
        "nbformat": 4,
        "nbformat_minor": 4,
    }


def notebook_to_bytes(nb: dict) -> bytes:
    return json.dumps(nb, indent=1).encode("utf-8")
