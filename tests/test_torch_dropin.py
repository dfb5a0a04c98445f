"""The drop-in ``libertem`` namespace on the port
(``libertem_tpu_torch/dropin.py``), the counterpart of the JAX
package's ``libertem/__init__.py`` and of ``tests/test_dropin.py``.

The tier-1 process already holds the JAX package's finder and
``libertem``, so every case that installs the port's finder runs in a
subprocess of its own (``PYTHONPATH`` the repository,
``JAX_PLATFORMS=cpu``, no device pin unless the case sets one): the
reference spellings of ``tests/test_dropin.py`` with class identity
against ``libertem_tpu_torch`` and a ``SumUDF`` run on the CPU against
numpy, an unknown submodule, the refusal to mix the two packages either
way round, attribute assignment through an alias, the script runner
(``python -m libertem_tpu_torch.dropin``) with a script, a module and
the four example scripts in their reference spelling, and the port's
device pins through the alias.  One case compares the port's layout
table with the JAX package's in this process.
"""
import importlib
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import libertem
import libertem_tpu_torch
from libertem_tpu_torch import dropin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINS = ("LIBERTEM_TPU_TORCH_USE_CPU", "LIBERTEM_TPU_TORCH_USE_DEVICE",
        "LIBERTEM_TPU_USE_CPU", "LIBERTEM_TPU_USE_DEVICE")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in PINS}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **extra)
    return env


def _run(args, tmp_path, code=None, env=None, check=True):
    """``python [args]`` in a subprocess, ``code`` written to a script
    in ``tmp_path`` and passed first when given; the completed
    process."""
    if code is not None:
        script = tmp_path / "script.py"
        script.write_text(textwrap.dedent(code))
        args = [str(script)] + list(args)
    proc = subprocess.run(
        [sys.executable] + list(args), cwd=str(tmp_path), env=env or _env(),
        capture_output=True, text=True, timeout=240,
    )
    if check:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _dropin(code, tmp_path, *args, env=None, check=True):
    """``code`` run as a script through the drop-in runner, with
    ``args``."""
    script = tmp_path / "script.py"
    script.write_text(textwrap.dedent(code))
    return _run(["-m", "libertem_tpu_torch.dropin", str(script)]
                + list(args), tmp_path, env=env, check=check)


# appended to a case's code (at its indentation): neither jax nor the
# JAX package was imported
NO_MIX = """
        bad = sorted(k for k in sys.modules
                     if k in ("jax", "libertem_tpu")
                     or k.startswith(("jax.", "libertem_tpu.")))
        assert not bad, bad
"""


def test_reference_spellings_are_the_port(tmp_path):
    """Each import spelling of ``tests/test_dropin.py`` resolves to the
    port's object (not a copy), and a SumUDF run on the CPU through
    them equals numpy's sum; neither jax nor the JAX package is
    imported."""
    out = _dropin("""
        import sys
        import numpy as np
        import libertem.api as lt
        from libertem.udf.base import UDF
        from libertem.udf.sum import SumUDF
        from libertem.udf.stddev import StdDevUDF
        from libertem.udf.masks import ApplyMasksUDF
        from libertem.udf.raw import PickUDF
        from libertem.udf.com import CoMUDF
        from libertem.common import Shape, Slice
        from libertem.common.buffers import BufferWrapper
        from libertem.common.container import MaskContainer
        from libertem.common.executor import JobExecutor
        from libertem.corrections import CorrectionSet
        from libertem import masks
        from libertem.io.dataset import load
        from libertem.io.dataset.memory import MemoryDataSet
        from libertem.executor.inline import InlineJobExecutor
        from libertem.viz import Dummy2DPlot
        from libertem.analysis import COMAnalysis
        import libertem

        import libertem_tpu_torch as p
        import libertem_tpu_torch.analysis as pa
        import libertem_tpu_torch.common.buffers as pb
        import libertem_tpu_torch.executor.base as pe
        import libertem_tpu_torch.io.dataset as pd
        import libertem_tpu_torch.io.dataset.memory as pm
        import libertem_tpu_torch.viz as pv
        assert libertem.__version__ == p.__version__
        assert libertem.Context is lt.Context is p.Context
        assert masks is p.masks
        pairs = [(UDF, p.UDF), (SumUDF, p.SumUDF), (StdDevUDF, p.StdDevUDF),
                 (ApplyMasksUDF, p.ApplyMasksUDF), (PickUDF, p.PickUDF),
                 (CoMUDF, p.CoMUDF), (Shape, p.Shape), (Slice, p.Slice),
                 (BufferWrapper, pb.BufferWrapper),
                 (MaskContainer, p.udf.MaskContainer),
                 (JobExecutor, pe.JobExecutor),
                 (CorrectionSet, p.CorrectionSet), (load, pd.load),
                 (MemoryDataSet, pm.MemoryDataSet),
                 (InlineJobExecutor, p.executor.InlineJobExecutor),
                 (Dummy2DPlot, pv.Dummy2DPlot),
                 (COMAnalysis, pa.COMAnalysis)]
        for alias, real in pairs:
            assert alias is real, (alias, real)

        ctx = lt.Context(device="cpu")
        data = np.random.default_rng(3).poisson(
            6.0, (4, 4, 8, 8)).astype(np.float32)
        ds = MemoryDataSet(data=data, sig_dims=2,
                           num_partitions=2).initialize()
        res = ctx.run_udf(ds, SumUDF())
        assert np.allclose(res["intensity"].data, data.sum(axis=(0, 1)),
                           rtol=1e-5)
        ds2 = load("memory", data=data, sig_dims=2, executor=ctx.executor)
        assert ds2.shape == ds.shape
    """ + NO_MIX + """
        print("spellings ok")
    """, tmp_path)
    assert "spellings ok" in out.stdout


def test_unknown_submodule_raises(tmp_path):
    _dropin("""
        import pytest
        with pytest.raises(ImportError):
            import libertem.does_not_exist  # noqa: F401
        with pytest.raises(ImportError):
            from libertem.udf import does_not_exist  # noqa: F401
    """, tmp_path)


def test_libertem_tpu_refused_after_install(tmp_path):
    """Once the finder is installed, the JAX package does not import,
    and jax is never pulled in."""
    _run([], tmp_path, code="""
        import sys
        import pytest
        from libertem_tpu_torch import dropin
        dropin.install()
        assert dropin.install() is sys.meta_path[0]
        import libertem.api  # noqa: F401
        with pytest.raises(ImportError, match="do not mix"):
            import libertem_tpu  # noqa: F401
        with pytest.raises(ImportError, match="do not mix"):
            import libertem_tpu.udf.sum  # noqa: F401
    """ + NO_MIX)


@pytest.mark.parametrize("first", ["libertem_tpu", "libertem"])
def test_install_refused_after_the_jax_package(first, tmp_path):
    """``install`` raises when the JAX package, or its ``libertem``,
    is already imported."""
    _run([], tmp_path, code=f"""
        import pytest
        import {first}  # noqa: F401
        from libertem_tpu_torch import dropin
        with pytest.raises(RuntimeError, match="already imported"):
            dropin.install()
    """)


def test_setattr_through_an_alias_reaches_the_port(tmp_path):
    """What ``monkeypatch.setattr("libertem.x.y", ...)`` does: setting
    and deleting through the alias changes the port's module; dunders
    stay on the alias."""
    _dropin("""
        import sys
        import libertem.udf.sum  # noqa: F401
        import libertem_tpu_torch.udf.sum as real
        alias = sys.modules["libertem.udf.sum"]
        assert alias is not real
        orig = real.SumUDF
        alias.SumUDF = "patched"
        assert real.SumUDF == "patched"
        alias.SumUDF = orig
        alias.extra_name = 1
        assert real.extra_name == 1
        del alias.extra_name
        assert not hasattr(real, "extra_name")
        assert alias.__name__ == "libertem.udf.sum"
        assert real.__name__ == "libertem_tpu_torch.udf.sum"
        import libertem_tpu_torch.udf
        assert libertem_tpu_torch.udf.sum is real
        assert sys.modules["libertem.udf"].sum is alias
    """, tmp_path)


def test_runner_runs_a_script_as_main(tmp_path):
    """The runner gives the script its arguments, ``__main__`` and its
    own directory on ``sys.path``, as ``python script.py`` does."""
    (tmp_path / "helper_mod.py").write_text("VALUE = 7\n")
    out = _dropin("""
        import sys
        import helper_mod
        import libertem
        if __name__ == "__main__":
            print("main", sys.argv[1:], helper_mod.VALUE,
                  type(libertem).__name__)
    """, tmp_path, "a", "--b")
    assert "main ['a', '--b'] 7 _DelegatingModule" in out.stdout


def test_runner_runs_a_module_through_the_alias(tmp_path):
    """``-m libertem.web.cli`` runs the port's module as ``__main__``
    (the finder hands runpy its code)."""
    out = _run(["-m", "libertem_tpu_torch.dropin", "-m", "libertem.web.cli",
                "--help"], tmp_path)
    assert "--port" in out.stdout


def test_runner_without_arguments_prints_its_usage(tmp_path):
    out = _run(["-m", "libertem_tpu_torch.dropin"], tmp_path, check=False)
    assert out.returncode == 2
    assert "usage" in out.stderr


@pytest.mark.parametrize("name", [
    "custom_udf", "holography", "strain_mapping", "virtual_detector",
])
def test_example_in_reference_spelling(name, tmp_path):
    """Each example script, ``libertem_tpu`` rewritten to ``libertem``
    (the reference spelling), runs through the runner on the port with
    its own asserts, on the CPU by the port's own pin."""
    with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
        src = f.read().replace("libertem_tpu", "libertem")
    script = tmp_path / f"{name}.py"
    script.write_text(src + "\n" + textwrap.dedent(NO_MIX).replace(
        "bad =", "import sys\nbad ="))
    out = _run(["-W", "ignore::UserWarning", "-m",
                "libertem_tpu_torch.dropin", str(script)], tmp_path,
               env=_env(LIBERTEM_TPU_TORCH_USE_CPU="0"))
    assert out.stdout
    if name == "strain_mapping":
        assert float(out.stdout.strip().splitlines()[-1].split(":")[1]) \
            < 0.01


def test_device_pins_through_the_alias(tmp_path):
    """The port's pins, reached as ``libertem.common.backend``: a CPU
    pin makes the default device the CPU, a card pin makes it the card
    (raising without one), and a JAX pin changes nothing."""
    _dropin("""
        import os
        import pytest
        import torch
        from libertem.common.backend import (
            get_device_class, get_use_cpu, get_use_cuda, resolve_device,
            set_use_cpu, set_use_cuda)
        from libertem.executor.inline import InlineJobExecutor
        import libertem.api as lt
        assert os.environ["LIBERTEM_TPU_USE_CPU"] == "0"
        assert not get_use_cpu() and get_use_cuda() is None
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_device(None)
        set_use_cpu(0)
        assert resolve_device(None) == torch.device("cpu")
        assert get_device_class() == "cpu"
        assert lt.Context().device == torch.device("cpu")
        assert InlineJobExecutor().main_device == torch.device("cpu")
        set_use_cuda(0)
        assert get_use_cuda() == 0 and not get_use_cpu()
        assert get_device_class() == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_device(None)
    """, tmp_path, env=_env(LIBERTEM_TPU_USE_CPU="0"))


def test_layout_table_is_the_jax_packages():
    """The port's table has the JAX package's keys and packages, each
    target the JAX target in the port, and each target imports."""
    assert set(dropin._EXPLICIT) == set(libertem._EXPLICIT)
    assert len(dropin._EXPLICIT) == 38
    assert dropin._FORCE_PACKAGE == libertem._FORCE_PACKAGE
    for key, target in dropin._EXPLICIT.items():
        want = libertem._EXPLICIT[key].replace(
            "libertem_tpu", "libertem_tpu_torch", 1)
        assert target == want
        assert importlib.import_module(target) is not None
    assert dropin._target("libertem") == "libertem_tpu_torch"
    assert dropin._target("libertem.udf.sum") == "libertem_tpu_torch.udf.sum"
    assert libertem_tpu_torch.__version__


def test_the_port_never_imports_libertem(tmp_path):
    """Importing every module of the port, the drop-in included,
    imports no ``libertem`` module (only the finder maps it)."""
    _run([], tmp_path, code="""
        import importlib, pkgutil, sys
        import libertem_tpu_torch as p
        for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
            importlib.import_module(m.name)
        assert "libertem_tpu_torch.dropin" in sys.modules
        bad = sorted(k for k in sys.modules
                     if k == "libertem" or k.startswith("libertem."))
        assert not bad, bad
    """ + NO_MIX)
