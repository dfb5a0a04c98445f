"""The drop-in ``libertem`` namespace on the port (counterpart of the
repository's ``libertem/__init__.py``, which maps ``libertem.*`` onto
the JAX package).

:func:`install` puts a meta-path finder at the head of
``sys.meta_path`` that serves ``libertem`` and every ``libertem.<sub>``
from the matching ``libertem_tpu_torch`` module, so scripts written
against the reference (``import libertem.api as lt``) run on the port
unchanged::

    from libertem_tpu_torch import dropin
    dropin.install()
    import libertem.api as lt

or, for a script or module that must run unmodified::

    python -m libertem_tpu_torch.dropin script.py [args]
    python -m libertem_tpu_torch.dropin -m libertem.web.cli [args]

Each ``libertem.*`` module is a thin delegating wrapper (PEP 562
``__getattr__``) of the port's module, never the module itself under a
second name: classes keep their identity, and setting or deleting an
attribute through an alias (``monkeypatch.setattr("libertem.x.y",
...)``) reaches the port.  The two packages never mix in a process:
:func:`install` raises when ``libertem`` or ``libertem_tpu`` is
already imported, and once it is installed ``import libertem_tpu``
raises ImportError.  This module imports no ``libertem`` or
``libertem_tpu`` module itself; it reaches ``libertem.*`` only through
its finder.
"""
import importlib
import importlib.abc
import importlib.util
import os
import runpy
import sys
import types

_PORT = "libertem_tpu_torch"

_EXPLICIT = {
    # corrections live under io/ here
    "libertem.corrections": "libertem_tpu_torch.io.corrections",
    "libertem.corrections.corrset": "libertem_tpu_torch.io.corrections",
    "libertem.corrections.detector": "libertem_tpu_torch.io.corrections",
    "libertem.corrections.coordinates":
        "libertem_tpu_torch.common.coordinates",
    # reference io/corrections is a package; ours is one module
    "libertem.io.corrections": "libertem_tpu_torch.io.corrections",
    "libertem.io.corrections.corrset": "libertem_tpu_torch.io.corrections",
    "libertem.io.corrections.detector":
        "libertem_tpu_torch.io.corrections",
    # the executor interfaces live in executor/, not common/
    "libertem.common.executor": "libertem_tpu_torch.executor.base",
    # encode_image lives with the viz backends here
    "libertem.common.viz": "libertem_tpu_torch.viz.base",
    # notebook-template helper (reference analysis/helper.py)
    "libertem.analysis.helper":
        "libertem_tpu_torch.web.notebook_generator",
    # MaskContainer lives with the masks UDF
    "libertem.common.container": "libertem_tpu_torch.udf.masks",
    # reference udf-method constants live on UDF itself here
    "libertem.common.udf": "libertem_tpu_torch.udf.base",
    # single-file DM loader is part of dm.py here
    "libertem.io.dataset.dm_single": "libertem_tpu_torch.io.dataset.dm",
    # reference io/dataset/base is a package; ours is one module,
    # with the decode protocol in a sibling
    "libertem.io.dataset.base.decode":
        "libertem_tpu_torch.io.dataset.decode",
    "libertem.io.dataset.base.utils":
        "libertem_tpu_torch.io.dataset.utils",
    "libertem.io.dataset.base.exceptions":
        "libertem_tpu_torch.io.dataset.base",
    "libertem.io.dataset.base.tiling_scheme":
        "libertem_tpu_torch.io.tiling",
    "libertem.io.dataset.base.backend":
        "libertem_tpu_torch.io.dataset.base",
    # reference executor module names that collapsed (docs in
    # executor/compat.py)
    "libertem.executor.dask": "libertem_tpu_torch.executor.compat",
    "libertem.executor.pipelined": "libertem_tpu_torch.executor.compat",
    "libertem.executor.concurrent": "libertem_tpu_torch.executor.compat",
    "libertem.executor.integration": "libertem_tpu_torch.executor.compat",
    # reference io/writers/results is a package; ours is one module
    "libertem.io.writers.base": "libertem_tpu_torch.io.writers",
    "libertem.io.writers.results": "libertem_tpu_torch.io.writers",
    "libertem.io.writers.results.base": "libertem_tpu_torch.io.writers",
    "libertem.io.writers.results.formats":
        "libertem_tpu_torch.io.writers",
    # reference web/notebook_generator is a package
    "libertem.web.notebook_generator":
        "libertem_tpu_torch.web.notebook_generator",
    "libertem.web.notebook_generator.notebook_generator":
        "libertem_tpu_torch.web.notebook_generator",
    "libertem.web.notebook_generator.copy":
        "libertem_tpu_torch.web.notebook_generator",
    # reference web/events.py names
    "libertem.web.events": "libertem_tpu_torch.web.server",
    "libertem.web.connect": "libertem_tpu_torch.web.server",
    "libertem.web.config": "libertem_tpu_torch.web.server",
    "libertem.web.jobs": "libertem_tpu_torch.web.server",
    "libertem.web.dataset": "libertem_tpu_torch.web.server",
    "libertem.web.analysis": "libertem_tpu_torch.web.server",
    "libertem.web.browse": "libertem_tpu_torch.web.server",
    "libertem.web.shutdown": "libertem_tpu_torch.web.server",
    "libertem.web.generator": "libertem_tpu_torch.web.server",
}

# aliased to a plain MODULE on our side but a PACKAGE in the
# reference (children resolved via _EXPLICIT)
_FORCE_PACKAGE = {
    "libertem.corrections", "libertem.io.corrections",
    "libertem.io.dataset.base",
    "libertem.io.writers", "libertem.io.writers.results",
    "libertem.web.notebook_generator",
}


_BLOCKED = "libertem_tpu"


def _target(fullname: str) -> str:
    """The port module behind ``libertem`` or ``libertem.<sub>``."""
    if fullname == "libertem":
        return _PORT
    return _EXPLICIT.get(fullname, _PORT + fullname[len("libertem"):])


def _is_name_of(fullname: str, package: str) -> bool:
    return fullname == package or fullname.startswith(package + ".")


class _DelegatingModule(types.ModuleType):
    """Alias module forwarding attribute access, assignment and
    deletion to the real module.  Dunder attributes (``__name__``,
    ``__spec__``, ``__path__``, ...) and child aliases stay local, so
    the import machinery never renames the real module, re-executes its
    submodules under the alias or binds an alias into it."""

    def __init__(self, name, real):
        super().__init__(name, real.__doc__)
        object.__setattr__(self, "_compat_real", real)

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "_compat_real"), name)

    def __setattr__(self, name, value):
        if name.startswith("__") and name.endswith("__") or isinstance(
                value, _DelegatingModule):
            # a child alias, bound by the import machinery, stays on
            # the alias: the real package keeps its real submodule
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_compat_real"), name,
                    value)

    def __delattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            object.__delattr__(self, name)
        else:
            delattr(object.__getattribute__(self, "_compat_real"), name)


class DropinFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves ``libertem`` and ``libertem.*`` from the port, and
    refuses ``libertem_tpu``."""

    def find_spec(self, fullname, path=None, target=None):
        if _is_name_of(fullname, _BLOCKED):
            raise ImportError(
                f"{fullname} cannot be imported: the drop-in maps "
                f"libertem onto {_PORT} in this process, and the two "
                "packages do not mix", name=fullname)
        if not _is_name_of(fullname, "libertem"):
            return None
        target_name = _target(fullname)
        try:
            real = importlib.import_module(target_name)
        except ModuleNotFoundError as e:
            if e.name != target_name:
                raise
            return None  # an unknown submodule: ModuleNotFoundError
        spec = importlib.util.spec_from_loader(
            fullname, self, origin=getattr(real, "__file__", None),
            is_package=(hasattr(real, "__path__")
                        or fullname in _FORCE_PACKAGE),
        )
        spec._compat_real = real
        return spec

    def create_module(self, spec):
        return _DelegatingModule(spec.name, spec._compat_real)

    def exec_module(self, module):
        real = module.__spec__._compat_real
        if hasattr(real, "__all__"):
            module.__dict__["__all__"] = real.__all__
        if module.__name__ == "libertem":
            # the top level's own names, as libertem/__init__.py's
            module.__dict__["__version__"] = real.__version__
            importlib.import_module(_PORT + ".masks")

    def get_code(self, fullname):
        """The real module's code, for ``python -m libertem.<mod>``:
        its ``__main__`` block runs, its relative imports resolve
        through this finder."""
        real = importlib.import_module(_target(fullname))
        path = getattr(real, "__file__", None)
        if path is None:
            raise ImportError(f"no source for {fullname}", name=fullname)
        with open(path) as f:
            return compile(f.read(), path, "exec")


def install() -> DropinFinder:
    """Put the finder at the head of ``sys.meta_path`` (once; a second
    call returns the installed one).  Raises RuntimeError when
    ``libertem`` or ``libertem_tpu`` is already imported."""
    for finder in sys.meta_path:
        if isinstance(finder, DropinFinder):
            return finder
    mixed = sorted(
        name for name in sys.modules
        if _is_name_of(name, "libertem") or _is_name_of(name, _BLOCKED))
    if mixed:
        raise RuntimeError(
            "install() must run before anything imports libertem or "
            f"libertem_tpu; already imported: {', '.join(mixed[:5])}")
    finder = DropinFinder()
    sys.meta_path.insert(0, finder)
    return finder


def main(argv=None) -> None:
    """``python -m libertem_tpu_torch.dropin script.py [args]`` (or
    ``-m module [args]``): install the finder, then run the script or
    module as ``__main__`` with ``sys.argv`` set as Python would."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[:1] == ["-m"] \
            and len(argv) < 2:
        print("usage: python -m libertem_tpu_torch.dropin "
              "(script.py | -m module) [args]", file=sys.stderr)
        raise SystemExit(2)
    install()
    if argv[0] == "-m":
        sys.argv = argv[1:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        return
    script = argv[0]
    sys.argv = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    # run the imported module's main, so that the installed finder is
    # the one ``libertem_tpu_torch.dropin`` holds
    from libertem_tpu_torch.dropin import main as _main
    _main()
