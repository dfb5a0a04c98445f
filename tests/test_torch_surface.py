"""The port's public surface against the JAX package's, module by
module, on the CPU.

The walk: for every module of ``libertem_tpu`` (one case each), every
public name (a function, class or constant of the JAX package defined
or re-exported there) must be in the port's module of the same path;
for each class defined there, its own attributes, its dataclass fields
and the protocol dunders it defines; and for each function, method and
constructor, its named parameters (a constructor or method of the port
that takes ``**kwargs`` is followed to the same method of its base,
where the keywords go).  The only exceptions are ``EXCLUDED``, each
with its reason: what exists for the TPU only, and what the port lays
out differently on purpose.

After the walk, the ported names are each called in both packages on
the same seeded numpy inputs: results equal, or within 1e-5 relative
where float32 sums run in another order.
"""
import asyncio
import dataclasses
import importlib
import inspect
import os
import pkgutil
import types
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import libertem_tpu
import libertem_tpu.api as japi
import libertem_tpu.common.backend as jbackend
import libertem_tpu.common.buffers as jbuffers
import libertem_tpu.common.math as jmath
import libertem_tpu.common.progress as jprogress
import libertem_tpu.io.tiling as jtiling
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
import libertem_tpu.udf.base as jbase
import libertem_tpu.udf.masks as jmasks
import libertem_tpu.udf.stddev as jstddev
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline

import libertem_tpu_torch as port
import libertem_tpu_torch.common.backend as pbackend
import libertem_tpu_torch.common.buffers as pbuffers
import libertem_tpu_torch.common.math as pmath
import libertem_tpu_torch.common.progress as pprogress
import libertem_tpu_torch.io.tiling as ptiling
import libertem_tpu_torch.udf.base as pbase
import libertem_tpu_torch.udf.masks as pmasks
import libertem_tpu_torch.udf.stddev as pstddev

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (4, 6), (8, 8)

# qualified JAX name -> why the port has no counterpart.  A member is
# "<module>.<Class>.<attr>", a parameter "<module>.<function>(<name>)"
# or "<module>.<Class>(<name>)" for a constructor.
EXCLUDED = {
    # for the TPU only
    "libertem_tpu.udf.base.UDF.BACKEND_JAX":
        "the JAX engine's backend spelling; the port's device engine "
        "is UDF.BACKEND_TORCH",
    "libertem_tpu.common.backend.get_pinned_device":
        "returns a jax device; the port's pins resolve to a torch "
        "device in resolve_device(None)",
    "libertem_tpu.common.backend.device_put_safe":
        "complex transfers as two real planes, for a TPU backend "
        "without complex host-device copies; torch copies complex "
        "tensors to the card directly",
    "libertem_tpu.common.backend.asarray_safe":
        "the device-to-host side of device_put_safe (TPU only)",
    "libertem_tpu.common.backend.device_zeros_safe":
        "complex zeros built on the TPU (TPU only)",
    "libertem_tpu.ops.moments.USE_PALLAS":
        "chooses between the Pallas kernel and XLA; the port runs its "
        "CUDA kernel on a card tensor and the plain version on a CPU "
        "tensor, by the tensor's device",
    "libertem_tpu.ops.moments.fused_moments(force_xla)":
        "the XLA fallback of the TPU kernel; no such path in the port",
    "libertem_tpu.ops.moments.fused_moments(data_terms)":
        "the host feed's certificate of the MXU passes a block needs; "
        "the CUDA kernel's warp votes find per sub-tile which TF32 "
        "passes its data needs",
    # laid out differently on purpose
    "libertem_tpu.native":
        "the C++ decoders' module; the port's counterpart is "
        "ops/decode.py with csrc/decode.cpp",
    "libertem_tpu.web.notebook_generator.GeneratorHelper.get_roi":
        "the JAX helper imports roi_code_lines, which the JAX package "
        "does not have",
    "libertem_tpu.io.dataset.base.Block.local_offset":
        "the port's block layout: a block carries its global offset "
        "only; the runner binds per partition from "
        "Partition.roi_offset",
    "libertem_tpu.io.dataset.base.Block(local_offset)":
        "as Block.local_offset",
    "libertem_tpu.io.dataset.dm.DMPartition(count)":
        "the port's partitions read through their dataset's "
        "FileRecords; the JAX layout's reader arguments have no "
        "meaning there",
    "libertem_tpu.io.dataset.k2is.K2ISPartition(frame_table)":
        "as DMPartition(count): the K2IS sector layout is the "
        "dataset's",
    "libertem_tpu.io.dataset.mib.MIBPartition(paths_and_offsets)":
        "as DMPartition(count): the MIB files are the dataset's "
        "FileRecords",
}

# the port's instance of a class whose JAX dataclass fields the port
# keeps as instance attributes
INSTANCES = {
    "libertem_tpu.io.dataset.base.Block": lambda: port.io.dataset.base.Block(
        global_offset=0, coords=np.zeros((1, 2), np.int32), valid=1,
        data=np.zeros((1, 4, 4), np.uint16)),
}

PLAIN = (int, float, str, bool, tuple, frozenset, dict, list, set, bytes,
         type(None))
DUNDERS = {"__len__", "__getitem__", "__setitem__", "__iter__",
           "__contains__", "__call__", "__enter__", "__exit__",
           "__aenter__", "__aexit__", "__aiter__", "__anext__", "__next__",
           "__array__", "__add__"}


def _jax_modules() -> list:
    # a package that fails to import is still listed, and fails its
    # own case rather than the collection of this file
    mods = ["libertem_tpu"] + [
        m.name for m in pkgutil.walk_packages(
            libertem_tpu.__path__, "libertem_tpu.", onerror=lambda _: None)]
    return sorted(m for m in mods if not m.startswith("libertem_tpu.native."))


def _public(mod) -> dict:
    """The JAX package's names in ``mod``: functions, classes and
    constants of the package, defined there or re-exported."""
    out = {}
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        owner = ("libertem_tpu" if isinstance(value, PLAIN)
                 else getattr(value, "__module__", None))
        if isinstance(owner, str) and owner.split(".")[0] == "libertem_tpu":
            out[name] = value
    return out


def _names(fn) -> list:
    """Named parameters of ``fn`` (not self/cls, private or *args)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return []
    return [p.name for p in params
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and p.name not in ("self", "cls") and not p.name.startswith("_")]


def _takes_kwargs(fn) -> bool:
    try:
        return any(p.kind is p.VAR_KEYWORD
                   for p in inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False


def _port_names(owner, attr) -> set:
    """Parameter names the port's ``owner.attr`` takes: its own, and,
    while it takes ``**kwargs``, those of the same method further up
    the MRO (where it forwards them)."""
    if not inspect.isclass(owner):
        return set(_names(owner))
    names = set()
    for klass in owner.__mro__:
        if attr not in vars(klass):
            continue
        fn = getattr(klass, attr)
        names.update(_names(fn))
        if not _takes_kwargs(fn):
            break
    return names


def _unwrap(value):
    return value.__func__ if isinstance(value, (staticmethod, classmethod)) \
        else value


def _own(cls) -> dict:
    """A JAX class's own public attributes, protocol dunders and
    dataclass fields."""
    out = {n: v for n, v in vars(cls).items()
           if not n.startswith("_") or n in DUNDERS}
    if dataclasses.is_dataclass(cls):
        for f in dataclasses.fields(cls):
            if not f.name.startswith("_"):
                out.setdefault(f.name, None)
    return out


def _missing_params(jfn, powner, pattr, key) -> list:
    have = _port_names(powner, pattr)
    return [f"{key}({n})" for n in _names(jfn) if n not in have]


def _misses(modname) -> list:
    """What the port's counterpart of ``modname`` lacks, no exclusion
    applied: ``(name, home)`` pairs of qualified JAX names, ``home``
    the defining module's name of a re-exported function or class
    (else ``name``)."""
    jmod = importlib.import_module(modname)
    try:
        pmod = importlib.import_module(_port_name(modname))
    except ImportError:
        return [(modname, modname)]
    missing = []
    for name, jval in _public(jmod).items():
        key = f"{modname}.{name}"
        if not hasattr(pmod, name):
            home = (f"{jval.__module__}.{jval.__qualname__}"
                    if hasattr(jval, "__qualname__") else key)
            missing.append((key, home))
            continue
        pval = getattr(pmod, name)
        defined_here = (getattr(jval, "__module__", None) == modname
                        and getattr(jval, "__name__", None) == name)
        found = []
        if inspect.isclass(jval) and defined_here:
            found += _missing_params(jval.__init__, pval, "__init__", key)
            instance = None
            fields = ({f.name for f in dataclasses.fields(pval)}
                      if dataclasses.is_dataclass(pval) else set())
            for attr, jattr in _own(jval).items():
                akey = f"{key}.{attr}"
                if attr in fields:
                    continue
                if not hasattr(pval, attr):
                    if instance is None and key in INSTANCES:
                        instance = INSTANCES[key]()
                    if instance is None or not hasattr(instance, attr):
                        found.append(akey)
                    continue
                jfn = _unwrap(jattr)
                if attr != "__init__" and inspect.isfunction(jfn):
                    found += _missing_params(jfn, pval, attr, akey)
        elif inspect.isfunction(jval) and defined_here:
            found += _missing_params(jval, pval, None, key)
        missing += [(k, k) for k in found]
    return missing


@pytest.mark.parametrize("modname", _jax_modules())
def test_public_surface(modname):
    """Every public name of the JAX module, its classes' attributes
    and its parameters are in the port's module of the same path."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        missing = [name for name, home in _misses(modname)
                   if name not in EXCLUDED and home not in EXCLUDED]
    assert not missing, f"the port lacks {missing}"


def test_exclusions_are_current():
    """Each exclusion is something the walk finds missing without it:
    an exclusion the port no longer needs is an error."""
    found = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for modname in _jax_modules():
            for name, home in _misses(modname):
                found.update((name, home))
    assert set(EXCLUDED) <= found, set(EXCLUDED) - found


def _port_name(modname: str) -> str:
    return "libertem_tpu_torch" + modname[len("libertem_tpu"):]


# -- call-level checks of the ported names ------------------------------------


def _data(seed=7, nav=NAV, sig=SIG, dtype=np.uint16):
    return np.random.default_rng(seed).poisson(6.0, nav + sig).astype(dtype)


def _contexts():
    return port.Context(device="cpu"), japi.Context(executor=JaxInline())


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=rtol, atol=rtol * max(
        1.0, float(np.abs(want).max(initial=0))), equal_nan=True)


def test_package_reexports_are_the_modules_names():
    from libertem_tpu_torch import api, common, io, udf
    assert common.Shape is port.Shape and common.Slice is port.Slice
    assert common.SliceUsageError is port.common.slice.SliceUsageError
    assert io.CorrectionSet is port.CorrectionSet
    assert io.Negotiator is ptiling.Negotiator
    assert io.TilingScheme is ptiling.TilingScheme
    assert udf.UDFRunCancelled is port.common.exceptions.UDFRunCancelled
    assert api.BufferWrapper is pbuffers.BufferWrapper
    assert pmasks.Slice is port.Slice
    for modname in ("analysis.raw", "io.dataset.base", "io.dataset.mib",
                    "io.dataset.raw_csr"):
        mod = importlib.import_module(f"libertem_tpu_torch.{modname}")
        assert mod.prod is pmath.prod
        assert mod.prod((3, 4)) == 12
    assert sorted(common.__all__) == sorted(libertem_tpu.common.__all__)
    assert sorted(io.__all__) == sorted(libertem_tpu.io.__all__)


@pytest.mark.parametrize("filetype", ["memory", "raw"])
def test_load_like_jax(filetype, tmp_path):
    """``io.dataset.load`` (executor accepted) gives the dataset the
    JAX ``load`` gives: same shape and dtype, and the same frame sums
    through SumSigUDF."""
    from libertem_tpu.io.dataset import load as jload
    from libertem_tpu_torch.io.dataset import load
    data = _data()
    if filetype == "memory":
        kw = dict(data=data, sig_dims=2)
    else:
        path = tmp_path / "scan.raw"
        data.tofile(path)
        kw = dict(path=str(path), nav_shape=NAV, sig_shape=SIG,
                  dtype="uint16")
    ctx, jctx = _contexts()
    ds = load(filetype, executor=ctx.executor, **kw)
    jds = jload(filetype, executor=jctx.executor, **kw)
    assert tuple(ds.shape) == tuple(jds.shape)
    assert ds.dtype == jds.dtype
    got = ctx.run_udf(ds, port.SumSigUDF())["intensity"].data
    want = jctx.run_udf(jds, libertem_tpu.udf.SumSigUDF())["intensity"].data
    _close(got, want)
    assert ds.initialize(ctx.executor) is ds


def test_detect_and_initialize_take_an_executor(tmp_path):
    import libertem_tpu.io.dataset as jds_mod
    import libertem_tpu_torch.io.dataset as pds_mod
    path = tmp_path / "scan.npy"
    np.save(path, _data())
    want = jds_mod.detect(str(path), executor=None)
    assert pds_mod.detect(str(path), executor=None) == want
    ds = pds_mod.detect_and_load(str(path), executor=None)
    assert tuple(ds.shape) == NAV + SIG
    cls = pds_mod.get_dataset_cls("npy")
    assert cls.detect_params(str(path), executor=None) == \
        jds_mod.get_dataset_cls("npy").detect_params(str(path), None)


def test_math_helpers_like_jax():
    rng = np.random.default_rng(2)
    dense = rng.random((6, 7)) > 0.6
    for mask in (dense, sp.csr_matrix(dense), sp.coo_matrix(dense), None):
        assert pmath.count_nonzero(mask) == jmath.count_nonzero(mask)
    for shape in ((16,), (15,), (4, 4), (1,), (49,)):
        assert pmath.make_2D_square(shape) == jmath.make_2D_square(shape)
    with pytest.raises(ValueError):
        pmath.make_2D_square((0,))
    assert np.array_equal(pmath.flat_nonzero(dense),
                          jmath.flat_nonzero(dense))
    for arr in (dense.astype(int), sp.coo_matrix(dense.astype(int))):
        assert list(pmath.ndenumerate(arr)) == list(jmath.ndenumerate(arr))


@pytest.fixture
def no_pins(monkeypatch):
    """Both packages' pin variables absent, restored after the case."""
    for name in ("LIBERTEM_TPU_TORCH_USE_CPU", "LIBERTEM_TPU_TORCH_USE_DEVICE",
                 "LIBERTEM_TPU_USE_CPU", "LIBERTEM_TPU_USE_DEVICE"):
        monkeypatch.setenv(name, "0")
        monkeypatch.delenv(name)


def test_device_pins_like_jax(no_pins):
    """The same sequence of pins reads back the same in both packages
    (each in its own variables); on this CPU host the default device
    follows the port's pin."""
    def state(mod):
        return mod.get_use_cpu(), mod.get_use_cuda(), mod.get_use_device(), \
            mod.get_device_class()

    assert state(pbackend) == state(jbackend)
    for step in (lambda m: m.set_use_cpu(0), lambda m: m.set_use_cuda(2),
                 lambda m: m.set_use_device(1), lambda m: m.set_use_cpu(3)):
        step(pbackend)
        step(jbackend)
        assert state(pbackend) == state(jbackend)
    assert pbackend.resolve_device(None) == torch.device("cpu")
    assert port.Context().device == torch.device("cpu")
    pbackend.set_use_cuda(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pbackend.resolve_device(None)
    assert pbackend.resolve_device("cpu") == torch.device("cpu")


def test_jax_pins_do_not_steer_the_port(no_pins, monkeypatch):
    """``LIBERTEM_TPU_USE_CPU`` pins the JAX package only: without a
    pin of its own the port's default stays the card (raising here)."""
    jbackend.set_use_cpu(0)
    assert jbackend.get_use_cpu()
    assert not pbackend.get_use_cpu() and pbackend.get_use_cuda() is None
    if not torch.cuda.is_available():
        assert pbackend.get_device_class() == "cpu"
        with pytest.raises(RuntimeError, match="CUDA"):
            pbackend.resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            port.Context()


def test_set_file_limit_raises_the_soft_limit():
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        pbackend.set_file_limit()
        assert resource.getrlimit(resource.RLIMIT_NOFILE) == (hard, hard)
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def test_bbox_helpers_like_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        arr = rng.random((9, 11)) > 0.8
        arr[rng.integers(9)] = True
        for fn in ("get_bbox_slice", "get_bbox"):
            assert getattr(pbuffers, fn)(arr) == getattr(jbuffers, fn)(arr)
        for axis in (0, 1):
            assert pbuffers.get_inner_slice(arr, axis) == \
                jbuffers.get_inner_slice(arr, axis)
        vals = rng.normal(size=(9, 11)) * arr
        assert pbuffers.get_bbox_2d(vals) == jbuffers.get_bbox_2d(vals)
    empty = np.zeros((3, 4))
    assert pbuffers.get_bbox_2d(empty) == jbuffers.get_bbox_2d(empty)
    assert pbuffers.get_bbox(empty) == jbuffers.get_bbox(empty)


def test_buffer_utilities_like_jax():
    a = np.arange(24).reshape(4, 6)
    assert np.array_equal(pbuffers.reshaped_view(a, (6, 4)),
                          jbuffers.reshaped_view(a, (6, 4)))
    for mod in (pbuffers, jbuffers):
        with pytest.raises(AttributeError):
            mod.reshaped_view(a.T, (24,))
    for size, dtype in (((3, 5), "float32"), ((0,), "uint8"), ((7,), "c8")):
        z = pbuffers.zeros_aligned(size, dtype)
        assert z.shape == size and z.dtype == np.dtype(dtype)
        assert not z.any()
        if z.size:
            assert z.ctypes.data % 4096 == 0
        assert z.shape == jbuffers.zeros_aligned(size, dtype).shape
    assert len(pbuffers.bytes_aligned(100)) == 100
    assert pbuffers.empty_aligned((2, 3), "u2").shape == (2, 3)
    pool = pbuffers.BufferPool()
    with pool.zeros((4,), "f4") as buf:
        first = buf.ctypes.data
    with pool.empty((4,), "f4") as buf:
        assert buf.ctypes.data == first  # the free list gave it back
    managed = pbuffers.ManagedBuffer(pool, 4096, 4096)
    assert len(managed.buf) == 4096
    t = torch.arange(5)
    assert np.array_equal(pbuffers.to_numpy(t), np.arange(5))
    assert pbuffers.to_numpy(a) is a
    for mod in (pbuffers, jbuffers):
        with pytest.raises(TypeError):
            mod.to_numpy([1, 2])
    s1 = port.Slice((0, 0, 0), port.Shape((2, 4, 4), 2))
    s2 = port.Slice((2, 0, 0), port.Shape((2, 4, 4), 2))
    assert pbuffers.disjoint(s1, [s2]) and not pbuffers.disjoint(s1, [s1])


def test_mask_and_placeholder_buffers_like_jax():
    arr = np.arange(6.0).reshape(2, 3)
    for mod in (pbuffers, jbuffers):
        with pytest.raises(mod.InvalidMaskError):
            mod.ArrayWithMask(arr, np.ones((2, 3), np.uint8))
        with pytest.raises(mod.InvalidMaskError):
            mod.ArrayWithMask(arr, np.ones((4,), bool))
        wm = mod.ArrayWithMask(arr, True)
        assert wm.mask.shape == arr.shape
        assert np.asarray(wm, dtype=np.float32).dtype == np.float32
        ph = mod.PlaceholderBufferWrapper("nav", (2,), "float32")
        assert ph.use == "result_only"
        with pytest.raises(ValueError):
            np.asarray(ph)
        pre = mod.PreallocBufferWrapper(arr, "single", (2, 3), "float64")
        assert pre._data is arr
    assert isinstance(port.UDF.buffer("sig", use="result_only"),
                      pbuffers.PlaceholderBufferWrapper)


def test_aux_new_for_partition_like_jax():
    data = _data()
    roi = np.zeros(NAV, bool)
    roi[1:3, 2:] = True
    aux = np.arange(np.prod(NAV) * 2, dtype=np.float32).reshape(NAV + (2,))
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    pw = port.UDF.aux_data(aux, kind="nav", extra_shape=(2,))
    jw = libertem_tpu.udf.UDF.aux_data(aux, kind="nav", extra_shape=(2,))
    for p, j in zip(ds.get_partitions(), jds.get_partitions()):
        for r in (None, roi):
            assert np.array_equal(pw.new_for_partition(p, r).raw_data,
                                  jw.new_for_partition(j, r).raw_data)


def test_sparse_to_coo_like_jax():
    from libertem_tpu.common.sparse import sparse_to_coo as jcoo
    from libertem_tpu_torch.common.sparse import sparse_to_coo
    dense = np.eye(4)
    assert sparse_to_coo(dense) is dense and sparse_to_coo(None) is None
    got, want = sparse_to_coo(sp.csr_matrix(dense)), jcoo(sp.csr_matrix(dense))
    assert got.format == want.format == "coo"
    assert np.array_equal(got.toarray(), want.toarray())


class _Comms:
    def __init__(self):
        self.subs = {}

    def subscribe(self, topic, cb):
        self.subs.setdefault(topic, []).append(cb)


class _Reporter:
    def __init__(self, log):
        self.log = log

    def start(self, state):
        self.log.append(("start", tuple(state)[:5]))

    def update(self, state):
        self.log.append(("update", tuple(state)[:5]))

    def end(self, state):
        self.log.append(("end", tuple(state)[:5]))


def test_progress_messages_like_jax(monkeypatch):
    """The message path of ProgressManager (``connect`` and the three
    handlers, tile elements over ``sig_size``) and the partition
    trackers report the same states and send the same messages in both
    packages, on the same patched clock."""
    logs = []
    for mod in (pprogress, jprogress):
        log = []
        mgr = mod.ProgressManager(20, 2, reporter=_Reporter(log),
                                  task_max={"a": 12, "b": 8}, sig_size=64)
        comms = _Comms()
        mgr.connect(comms)
        comms.subs["partition_start"][0]("partition_start", {"ident": "a"})
        comms.subs["tile_complete"][0]("tile_complete",
                                       {"ident": "a", "elements": 320})
        comms.subs["tile_complete"][0]("tile_complete",
                                       {"ident": "a", "elements": 6400})
        comms.subs["partition_complete"][0]("partition_complete",
                                            {"ident": "a"})
        with pytest.raises(RuntimeError):
            mgr.handle_start_task("tile_complete", {"ident": "b"})
        mgr.close()

        sent = []

        class Ctx:
            def signal(self, ident, topic, msg):
                sent.append((ident, topic, dict(msg)))

        clock = iter([0.0, 0.5, 1.2, 1.3, 2.5, 4.0])
        monkeypatch.setattr(mod, "get_time", lambda: next(clock))
        tracker = mod.PartitionProgressTracker("p0", Ctx(), sig_size=16,
                                               min_message_interval=1.0)
        tracker.signal_start()
        tracker.signal_frames_complete(3)
        tracker.signal_frames_complete(3)
        tracker.signal_complete()
        noop = mod.PartitionTrackerNoOp()
        noop.signal_start()
        noop.signal_frames_complete(5)
        logs.append((log, sent))
    assert logs[0] == logs[1]
    assert logs[0][1][1] == ("p0", "tile_complete", {"elements": 48})


def test_tiling_scheme_like_jax():
    data = _data()
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=2)
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=2)
    for udfs, judfs in (([port.SumUDF()], [libertem_tpu.udf.SumUDF()]),
                        ([port.PickUDF()], [libertem_tpu.udf.PickUDF()])):
        for kw in ({}, {"approx_partition_shape": port.Shape(
                (12,) + SIG, 2)}, {"roi": np.ones(NAV, bool)}):
            pkw = dict(kw)
            jkw = dict(kw)
            if "approx_partition_shape" in kw:
                jkw["approx_partition_shape"] = libertem_tpu.common.Shape(
                    (12,) + SIG, 2)
            s = ptiling.Negotiator().get_scheme(udfs, dataset=ds, **pkw)
            j = jtiling.Negotiator().get_scheme(judfs, dataset=jds, **jkw)
            assert (s.depth, len(s), s.intent) == (j.depth, len(j), j.intent)
            assert tuple(s[0].shape) == tuple(j[0].shape)
            assert s[0].origin == j[0].origin
    full = port.Shape(NAV + SIG, 2)
    sch = ptiling.TilingScheme.make_for_shape(
        port.Shape((5, 4, 8), 2), full, intent="partition")
    jsch = jtiling.TilingScheme.make_for_shape(
        libertem_tpu.common.Shape((5, 4, 8), 2),
        libertem_tpu.common.Shape(NAV + SIG, 2), intent="partition")
    assert [tuple(x.shape) for x in sch.sig_slices] == \
        [tuple(x.shape) for x in jsch.sig_slices]
    assert sch == ptiling.TilingScheme.make_for_shape(
        port.Shape((5, 4, 8), 2), full, intent="partition")
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        a, b = sch.adjust_for_partition(p), jsch.adjust_for_partition(jp)
        assert a.depth == b.depth == p.num_frames
        assert a.adjust_for_partition(p) is a
    tile = ptiling.TilingScheme.make_for_shape(
        port.Shape((5, 8, 8), 2), full)
    assert tile.adjust_for_partition(next(ds.get_partitions())) is tile
    assert set(ptiling.TilingPreferences.__annotations__) == \
        set(jtiling.TilingPreferences.__annotations__)


def test_dataset_class_surface_like_jax(tmp_path):
    import libertem_tpu.io.dataset.base as jdsbase
    import libertem_tpu_torch.io.dataset.base as pdsbase
    from libertem_tpu_torch.executor.base import NoopCommHandler
    from libertem_tpu_torch.io.dataset.live import LiveDataSet
    assert pdsbase.DataSet.MAX_PARTITION_SIZE == \
        jdsbase.DataSet.MAX_PARTITION_SIZE
    ctx, _ = _contexts()
    ds = ctx.load("memory", data=_data(), sig_dims=2)
    assert ds.supports_concurrent_reads is True
    assert LiveDataSet.supports_concurrent_reads is False
    assert isinstance(ds.get_task_comm_handler(), NoopCommHandler)
    from libertem_tpu.io.dataset.npy import NPYDatasetParams as JNpy
    from libertem_tpu.io.dataset.raw import RAWDatasetParams as JRaw
    from libertem_tpu_torch.io.dataset import converters
    from libertem_tpu_torch.io.dataset.npy import NPYDatasetParams
    from libertem_tpu_torch.io.dataset.raw import (
        RAWDatasetParams, RawDatasetParams)
    assert NPYDatasetParams is converters.NPYDatasetParams
    assert RAWDatasetParams is RawDatasetParams is converters.RawDatasetParams
    assert NPYDatasetParams.__name__ == JNpy.__name__
    assert RAWDatasetParams.__name__ == JRaw.__name__


def test_h5_cache_key_like_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "scan.h5")
    with h5py.File(path, "w") as f:
        f["data"] = _data()
    ctx, jctx = _contexts()
    for so in (0, 2):
        got = ctx.load("hdf5", path=path, ds_path="data", sync_offset=so)
        want = jctx.load("hdf5", path=path, ds_path="data", sync_offset=so)
        assert got.get_cache_key() == want.get_cache_key()


def test_warnings_and_compat_names():
    from libertem_tpu_torch.executor import base as pexec, compat
    from libertem_tpu_torch.warnings import (
        UseDiscouragedWarning, emit_use_discouraged)
    assert compat.JobExecutor is pexec.JobExecutor

    def discouraged():
        emit_use_discouraged("avoid this")

    with pytest.warns(UseDiscouragedWarning, match="avoid this") as rec:
        discouraged()
    assert rec[0].filename == __file__


def test_web_aliases_and_broadcast():
    pytest.importorskip("tornado")
    from libertem_tpu_torch.web import server, state
    assert server.ConnectHandler is server.ConnectionHandler
    assert server.LocalFSBrowseHandler is server.BrowseHandler
    assert server.LocalFSStatHandler is server.StatHandler
    assert state.DatasetState.remove_dataset is state.DatasetState.remove

    sent = []

    class Handler:
        def write_message(self, payload, binary=False):
            sent.append((payload, binary))
            fut = asyncio.get_running_loop().create_future()
            fut.set_result(None)
            return fut

    async def go():
        reg = server.EventRegistry()
        reg.add_handler(Handler())
        await reg.broadcast({"messageType": "X"})
        await reg.broadcast_binary(b"\x00\x01")

    asyncio.run(go())
    assert sent == [('{"messageType": "X"}', False), (b"\x00\x01", True)]


def test_udf_library_helpers_like_jax():
    """run_fem, run_logsum and run_analysis_crystall within 1e-5 of the
    JAX package's on the same data and roi."""
    from libertem_tpu.udf.crystallinity import run_analysis_crystall as jc
    from libertem_tpu.udf.FEM import run_fem as jf
    from libertem_tpu.udf.logsum import run_logsum as jl
    from libertem_tpu_torch.udf.crystallinity import run_analysis_crystall
    from libertem_tpu_torch.udf.FEM import run_fem
    from libertem_tpu_torch.udf.logsum import run_logsum
    data = _data(sig=(16, 16)).astype(np.float32)
    roi = np.zeros(NAV, bool)
    roi[1:] = True
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2)
    jds = jctx.load("memory", data=data, sig_dims=2)
    for r in (None, roi):
        _close(run_fem(ctx, ds, (8, 8), 2, 6, roi=r)["intensity"].data,
               jf(jctx, jds, (8, 8), 2, 6, roi=r)["intensity"].data)
        _close(run_logsum(ctx, ds, roi=r)["logsum"].data,
               jl(jctx, jds, roi=r)["logsum"].data)
        got = run_analysis_crystall(ctx, ds, 2, 6, real_center=(8, 8),
                                    real_rad=3, roi=r)
        want = jc(jctx, jds, 2, 6, real_center=(8, 8), real_rad=3, roi=r)
        _close(got["intensity"].data, want["intensity"].data)


def test_stddev_primitives_like_jax():
    rng = np.random.default_rng(9)
    tiles = [rng.normal(size=(n, 12)) + 1j * rng.normal(size=(n, 12))
             for n in (5, 0, 3, 7)]
    outs = []
    for mod in (pstddev, jstddev):
        n = 0
        s = np.zeros(12, complex)
        v = np.zeros(12)
        for t in tiles:
            n = mod.process_tile(t, n, s, v)
        a_sum, a_var = mod.merge_single(15, 8, s, v, 7, s * 0.5, v * 0.5,
                                        s * 0.5 / 7)
        outs.append((n, s.copy(), v.copy(), a_sum, a_var))
    for got, want in zip(*outs):
        assert np.allclose(got, want, rtol=1e-12)
    assert outs[0][0] == 15
    allv = np.concatenate(tiles)
    assert np.allclose(outs[0][2], (np.abs(allv - allv.mean(0)) ** 2).sum(0))


def test_auto_buffer_like_jax():
    from libertem_tpu.udf.auto import AutoUDF as JAuto
    for var in (np.zeros((3, 2), np.float64), np.zeros(4, np.int16)):
        got = port.AutoUDF(f=np.sum).auto_buffer(var)
        want = JAuto(f=np.sum).auto_buffer(var)
        assert (got.kind, got.extra_shape, got.dtype) == \
            (want.kind, want.extra_shape, want.dtype)
    got = port.AutoUDF(f=np.sum).auto_buffer(torch.zeros(2, 5,
                                                         dtype=torch.float64))
    assert got.extra_shape == (2, 5) and got.dtype == np.float32


def _mask_factories(sig=SIG):
    rng = np.random.default_rng(12)
    dense = rng.random(sig).astype(np.float32)
    sparse_mask = sp.csr_matrix((rng.random(sig) > 0.8).astype(np.float32))
    return [lambda: dense, lambda: sparse_mask]


@pytest.mark.parametrize("use_sparse", [None, False, True, "scipy.sparse.csc"])
def test_mask_container_like_jax(use_sparse):
    """MaskContainer's host surface (``get_masks_for_slice``, ``get``,
    ``dtype``, ``computed_masks``, ``len``, ``use_sparse``,
    ``get_for_sig_slice``) equal to the JAX package's."""
    f = _mask_factories()
    mc = pmasks.MaskContainer(f, use_sparse=use_sparse, backend="numpy",
                              default_sparse="scipy.sparse")
    jmc = jmasks.MaskContainer(f, use_sparse=use_sparse, backend="numpy",
                               default_sparse="scipy.sparse")
    assert len(mc) == len(jmc) == 2
    assert mc.dtype == jmc.dtype
    assert mc.use_sparse == jmc.use_sparse
    assert np.array_equal(mc.computed_masks, jmc.computed_masks)
    tiles = [((0, 0, 0), (4, 8, 8)), ((3, 2, 0), (2, 4, 8)),
             ((1, 4, 4), (1, 4, 4))]
    for origin, shape in tiles:
        sl = port.Slice(origin, port.Shape(shape, 2))
        jsl = libertem_tpu.common.Slice(origin,
                                        libertem_tpu.common.Shape(shape, 2))
        for kw in ({}, {"transpose": False}, {"dtype": np.float64},
                   {"sparse_backend": False}):
            got = mc.get_masks_for_slice(sl, **kw)
            want = jmc.get_masks_for_slice(jsl, **kw)
            assert sp.issparse(got) == sp.issparse(want)
            if sp.issparse(got):
                assert got.format == want.format
                got, want = got.toarray(), want.toarray()
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)
        got, want = mc.get(sl), jmc.get(jsl)
        if sp.issparse(got):
            got, want = got.toarray(), want.toarray()
        assert np.array_equal(got, want)
        sig_sl = sl.sig
        op = mc.get_for_sig_slice(sig_sl, SIG, np.float32)
        jop = jmc.get_for_sig_slice(jsl.sig, SIG, np.float32)
        assert isinstance(op, torch.Tensor)
        assert np.array_equal(op.numpy(), np.asarray(jop))
    with pytest.raises(TypeError):
        mc.get("not a slice")
    assert pmasks.MaskContainer(f, backend="cupy",
                                default_sparse="sparse.pydata").use_sparse \
        is False


def test_apply_masks_accepts_use_bf16():
    """``use_bf16=True`` runs the product on bfloat16 operands with
    float32 sums, as the JAX package does: on float32 data with a
    random mask, the port's result is the JAX package's (rtol 1e-5),
    float32, and not the float32 product's."""
    data = _data().astype(np.float32)
    f = _mask_factories()
    ctx, jctx = _contexts()
    res = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2),
                      port.ApplyMasksUDF(mask_factories=f, use_bf16=True))
    want = jctx.run_udf(jctx.load("memory", data=data, sig_dims=2),
                        libertem_tpu.udf.ApplyMasksUDF(mask_factories=f,
                                                       use_bf16=True))
    got = res["intensity"].data
    assert got.dtype == np.float32
    _close(got, want["intensity"].data)
    stack = np.stack([np.asarray(m()) if not sp.issparse(m()) else
                      m().toarray() for m in f])
    f32 = np.einsum("nyx,myx->nm", data.reshape(-1, *SIG).astype(np.float64),
                    stack.astype(np.float64)).reshape(NAV + (2,))
    assert not np.allclose(got, f32, rtol=1e-7)


def test_udf_constants_and_helpers_like_jax():
    assert port.UDF.UDF_METHOD is pbase.UDFMethod
    assert [m.value for m in port.UDF.UDF_METHOD] == \
        [m.value for m in libertem_tpu.udf.UDF.UDF_METHOD]
    assert pbase.UDFProtocol is port.UDF
    assert pbase.TileDepthEnum is ptiling.TileDepthEnum
    assert pbase.TilingPreferences is ptiling.TilingPreferences
    assert issubclass(pbase.JobCancelledError, Exception)
    for udf_backends, user in (
            [((port.UDF.BACKEND_NUMPY,),), None],
            [(("numpy", "cuda"), ("cupy",)), None],
            [(("numpy", "cupy"),), "numpy"],
            [(("cuda",),), None],
            [(("numpy",), ("cupy",)), None]):
        try:
            want = jbase.get_resources_for_backends(udf_backends, user)
        except ValueError:
            with pytest.raises(ValueError):
                pbase.get_resources_for_backends(udf_backends, user)
            continue
        assert pbase.get_resources_for_backends(udf_backends, user) == want
    # the device engine's backend counts as the JAX engine's does
    assert pbase.get_resources_for_backends(
        [("torch",), ("numpy",)], None) == jbase.get_resources_for_backends(
        [("jax",), ("numpy",)], None)
    assert jbase.CUDA_BACKENDS == pbase.CUDA_BACKENDS
    assert jbase.CPU_BACKENDS - {"jax"} == pbase.CPU_BACKENDS - {"torch"}


def test_merge_attr_mapping_like_jax():
    for mod in (pbase, jbase):
        d = {"a": np.zeros(3), "b": np.ones(2)}
        m = mod.MergeAttrMapping(d)
        m.a = np.arange(3)
        assert np.array_equal(d["a"], np.arange(3)) and "b" in m
        assert sorted(m) == ["a", "b"]
        with pytest.warns(FutureWarning):
            assert np.array_equal(m["b"], np.ones(2))
        with pytest.raises(AttributeError):
            m.c  # noqa: B018


def test_params_meta_and_results_like_jax():
    udfs = [port.SumUDF(), port.PickUDF()]
    p = pbase.UDFParams.from_udfs(udfs, roi="r", corrections="c",
                                  tiling_scheme="t")
    j = jbase.UDFParams.from_udfs([libertem_tpu.udf.SumUDF(),
                                   libertem_tpu.udf.PickUDF()],
                                  roi="r", corrections="c",
                                  tiling_scheme="t")
    assert {k: v for k, v in p.items()} == {k: v for k, v in j.items()}
    meta = pbase.UDFMeta(port.Shape(NAV + SIG, 2), "uint16", "float32",
                         device_class="cpu", array_backend="numpy")
    jmeta = jbase.UDFMeta(libertem_tpu.common.Shape(NAV + SIG, 2), "uint16",
                          "float32", device_class="cpu",
                          array_backend="numpy")
    assert (meta.device_class, meta.array_backend) == \
        (jmeta.device_class, jmeta.array_backend)
    assert pbase.UDFMeta(port.Shape(NAV + SIG, 2), "u2", "f4").array_backend \
        == "torch"
    calls = []

    def thunk():
        calls.append(1)
        return [{"x": 1}]

    for mod in (pbase, jbase):
        calls.clear()
        res = mod.UDFResults(damage="d", buffers_thunk=thunk)
        assert calls == []
        assert res.buffers == [{"x": 1}] and res.buffers == [{"x": 1}]
        assert calls == [1] and res.damage == "d"
        single = mod.SingleUDFResults({"x": 1}, "d")
        assert single.x == 1 and single.damage == "d"
    assert port.api.SingleUDFResults is pbase.SingleUDFResults


def _proto_udfs(lib):
    """A tile UDF with a sig buffer, a frame UDF with nav buffers and a
    partition UDF, each written with numpy."""
    class TileSum(lib.udf.UDF):
        def get_result_buffers(self):
            return {"s": self.buffer("sig", dtype="float64"),
                    "n": self.buffer("nav", dtype="float64")}

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def process_tile(self, tile):
            self.results.s[:] += tile.sum(axis=0)
            self.results.n[:] += tile.reshape(tile.shape[0], -1).sum(1)

        def merge(self, dest, src):
            dest.s[:] += src.s

    class FrameMax(lib.udf.UDF):
        def get_result_buffers(self):
            return {"m": self.buffer("nav", extra_shape=(2,),
                                     dtype="float32")}

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def process_frame(self, frame):
            self.results.m[:] = (frame.max(), self.meta.slice.origin[0])

    class PartCount(lib.udf.UDF):
        def get_result_buffers(self):
            return {"c": self.buffer("single", dtype="int64"),
                    "only": self.buffer("sig", use="result_only")}

        def get_backends(self):
            return (self.BACKEND_NUMPY,)

        def process_partition(self, partition):
            self.results.c[:] += partition.shape[0]

        def merge(self, dest, src):
            dest.c[:] += src.c

    return [TileSum(), FrameMax(), PartCount()]


@pytest.mark.parametrize("with_roi", [False, True])
def test_part_runner_like_jax(with_roi):
    """UDFs driven by hand over each partition through
    ``UDFPartRunner.run_for_partition`` (with ``UDFParams.from_udfs``)
    give the JAX package's buffers."""
    from libertem_tpu.executor.base import Environment as JEnv
    from libertem_tpu_torch.executor.base import Environment
    data = _data().astype(np.float32)
    roi = None
    if with_roi:
        roi = np.zeros(NAV, bool)
        roi[0, 1:4] = roi[2:] = True
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    for p, jp in zip(ds.get_partitions(), jds.get_partitions()):
        udfs, judfs = _proto_udfs(port), _proto_udfs(libertem_tpu)
        got = pbase.UDFPartRunner(udfs, debug=True).run_for_partition(
            p, pbase.UDFParams.from_udfs(udfs, roi=roi), Environment())
        want = jbase.UDFPartRunner(judfs, debug=True).run_for_partition(
            jp, jbase.UDFParams.from_udfs(judfs, roi=roi), JEnv())
        for g, w in zip(got, want):
            assert sorted(g.keys()) == sorted(w.keys())
            for k in g.keys():
                if w._get(k) is None:
                    assert g._get(k) is None
                    continue
                assert np.array_equal(g._get(k), w._get(k)), k
        assert not udfs[0].requires_custom_merge({})
        decls = udfs[2].get_result_buffers()
        assert udfs[2].requires_custom_merge_all(decls) == \
            judfs[2].requires_custom_merge_all(
                judfs[2].get_result_buffers())


def test_worker_protocol_methods_like_jax():
    data = _data()
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=2)
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=2)
    p, jp = next(ds.get_partitions()), next(jds.get_partitions())
    roi = np.ones(NAV, bool)
    roi[0] = False
    for udf, part in ((_proto_udfs(port)[0], p),
                      (_proto_udfs(libertem_tpu)[0], jp)):
        fresh = udf.copy_for_partition(part, roi)
        assert type(fresh) is type(udf) and fresh is not udf
        udf.set_backend("numpy")
        udf.set_slice(part.slice)  # no meta yet: nothing to set
        udf.init_result_buffers()
        udf.allocate_for_part(part, roi)
        udf.init_task_data()
        udf.clear_views()
        assert udf.results.s.shape == SIG
        assert udf.results.n.shape == (int(roi.reshape(-1)[
            part.slice.origin[0]:part.slice.origin[0]
            + part.slice.shape[0]].sum()),)


def test_runner_entry_points_like_jax():
    """``UDFRunner(progress_reporter=)``, ``run_for_dataset`` with the
    executor (positional and keyword), ``dry=`` and ``backends=``, and
    ``run_for_dataset_async``."""
    data = _data()
    ctx, jctx = _contexts()
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    jds = jctx.load("memory", data=data, sig_dims=2, num_partitions=3)
    log = []
    runner = pbase.UDFRunner([port.SumUDF()],
                             progress_reporter=_Reporter(log))
    res = runner.run_for_dataset(ds, ctx.executor, progress=True)
    assert log[0][0] == "start" and log[-1] == ("end", (24, 24, 3, 0, 3))
    want = jbase.UDFRunner([libertem_tpu.udf.SumUDF()]).run_for_dataset(
        jds, jctx.executor)
    assert np.array_equal(res.buffers[0]["intensity"].data,
                          want.buffers[0]["intensity"].data)
    res = pbase.UDFRunner([port.SumUDF()]).run_for_dataset(
        ds, executor=ctx.executor)
    assert np.array_equal(res.buffers[0]["intensity"].data,
                          data.sum((0, 1)))
    dry = pbase.UDFRunner([port.SumUDF()]).run_for_dataset(
        ds, executor=ctx.executor, dry=True)
    jdry = jbase.UDFRunner([libertem_tpu.udf.SumUDF()]).run_for_dataset(
        jds, jctx.executor, dry=True)
    assert dry.buffers[0]["intensity"].data.shape == \
        jdry.buffers[0]["intensity"].data.shape
    tile_sum = _proto_udfs(port)[0]
    runner = pbase.UDFRunner([tile_sum])
    res = runner.run_for_dataset(ds, ctx.executor, backends="numpy")
    assert runner.run_info["engines"] == ["host"]
    assert np.array_equal(res.buffers[0]["s"].data, data.sum((0, 1)))
    with pytest.raises(port.UDFException, match="restriction"):
        pbase.UDFRunner([tile_sum]).run_for_dataset(
            ds, ctx.executor, backends=("torch",))

    async def drain(r, d, executor):
        out = []
        async for part in r.run_for_dataset_async(d, executor,
                                                  cancel_id="c"):
            out.append(part)
        return out

    parts = asyncio.run(drain(pbase.UDFRunner([port.SumUDF()]), ds,
                              ctx.executor))
    jparts = asyncio.run(drain(jbase.UDFRunner([libertem_tpu.udf.SumUDF()]),
                               jds, jctx.executor))
    assert len(parts) == len(jparts) == 3
    for a, b in zip(parts, jparts):
        assert np.array_equal(a.damage.data, b.damage.data)
        assert np.array_equal(a.buffers[0]["intensity"].data,
                              b.buffers[0]["intensity"].data)


def test_host_runner_refresh_aux():
    from libertem_tpu_torch.udf.host import HostUDFRunner
    prep = {"input_dtype": np.float32, "n_nav": 4, "aux_host": [{"a": 1}],
            "meta": pbase.UDFMeta(port.Shape((4, 2, 2), 2), "f4", "f4")}
    runner = HostUDFRunner([], prep)
    new = dict(prep, aux_host=[{"a": 2}])
    runner.refresh_aux(new)
    assert runner._aux(0) == {"a": 2}
