"""The port's main path against the JAX package's, on the CPU.

The same numpy data (u16 counts from a seeded Poisson draw) and the
same five UDFs (ApplyMasks BF disk + ADF ring, CoM, Sum, SumSig,
StdDev) go through ``libertem_tpu_torch.Context(device="cpu")`` and
``libertem_tpu.api.Context``; every result buffer must agree.  Both
compute in float32 with different summation orders: rtol 1e-5, with
an absolute floor of 1e-5 of the buffer's largest magnitude (CoM
divergence and curl are differences of neighbouring shifts, so their
floor follows the field's magnitude).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf for _udfs)
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from libertem_tpu.udf.base import UDFRunner as JaxUDFRunner

import libertem_tpu_torch as port
from libertem_tpu_torch.convert import fused_plan_from_numpy
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.io.tiling import Negotiator
from libertem_tpu_torch.ops.moments import fused_moments
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

NAV, SIG = (16, 16), (32, 32)
RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (udf, buffer) pairs compared, and the buffer whose scale sets the
# absolute floor of each
BUFFERS = [
    (0, "intensity", "intensity"),
    (1, "raw_com", "raw_com"),
    (1, "raw_shifts", "raw_shifts"),
    (1, "field", "field"),
    (1, "field_y", "field"),
    (1, "field_x", "field"),
    (1, "magnitude", "magnitude"),
    (1, "divergence", "field"),
    (1, "curl", "field"),
    (1, "regression", "regression"),
    (2, "intensity", "intensity"),
    (3, "intensity", "intensity"),
    (4, "num_frames", "num_frames"),
    (4, "sum", "sum"),
    (4, "varsum", "varsum"),
    (4, "var", "var"),
    (4, "std", "std"),
    (4, "mean", "mean"),
]


def _data(seed=0):
    return np.random.default_rng(seed).poisson(
        8.0, NAV + SIG
    ).astype(np.uint16)


def _udfs(lib):
    m = lib.masks
    h, w = SIG
    return [
        lib.udf.ApplyMasksUDF(mask_factories=[
            lambda: m.circular(w // 2, h // 2, w, h, 4),
            lambda: m.ring(w // 2, h // 2, w, h, 15, 10),
        ]),
        lib.udf.CoMUDF.with_params(cy=h // 2, cx=w // 2, r=8),
        lib.udf.SumUDF(),
        lib.udf.SumSigUDF(),
        lib.udf.StdDevUDF(),
    ]


def _compare(ours, theirs):
    for ui, name, scale_name in BUFFERS:
        a = np.asarray(ours[ui][name].data, dtype=np.float64)
        b = np.asarray(theirs[ui][name].data, dtype=np.float64)
        scale = max(float(np.nanmax(np.abs(
            np.asarray(theirs[ui][scale_name].data, np.float64)
        ), initial=0.0)), 1.0)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            a, b, rtol=RTOL, atol=RTOL * scale, err_msg=f"{ui}/{name}"
        )
        assert np.array_equal(
            np.asarray(ours[ui][name].valid_mask),
            np.asarray(theirs[ui][name].valid_mask),
        ), name


@pytest.fixture(scope="module")
def jax_memory_results():
    ds = JaxMemoryDataSet(data=_data(), sig_dims=2, num_partitions=3)
    ctx = JaxContext(executor=InlineJobExecutor())
    return ctx.run_udf(ds, _udfs(libertem_tpu))


@pytest.mark.parametrize("target_block_bytes,n_blocks", [
    (Negotiator.TARGET_BLOCK_BYTES, 3),
    # 32 frames a block: several blocks per partition, more blocks
    # than feed slots, a padded tail in each partition
    (32 * 32 * 32 * 4, 9),
])
def test_memory_slice_matches_jax(jax_memory_results, monkeypatch,
                                  target_block_bytes, n_blocks):
    monkeypatch.setattr(
        Negotiator, "TARGET_BLOCK_BYTES", target_block_bytes
    )
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=_data(), sig_dims=2, num_partitions=3)
    ours = ctx.run_udf(ds, _udfs(port))
    _compare(ours, jax_memory_results)
    assert ctx.feed_stats["blocks"] == n_blocks


def test_raw_slice_matches_jax(tmp_path):
    data = _data(seed=1)
    path = tmp_path / "scan.raw"
    data.tofile(path)
    kw = dict(path=str(path), dtype="uint16", nav_shape=NAV,
              sig_shape=SIG)
    theirs = JaxContext(executor=InlineJobExecutor()).run_udf(
        JaxContext(executor=InlineJobExecutor()).load("raw", **kw),
        _udfs(libertem_tpu),
    )
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(ctx.load("raw", **kw), _udfs(port))
    _compare(ours, theirs)
    # and the plain float64 answers
    f = data.astype(np.float64)
    assert np.array_equal(ours[2]["intensity"].data, f.sum(axis=(0, 1)))
    assert np.array_equal(ours[3]["intensity"].data, f.sum(axis=(2, 3)))
    np.testing.assert_allclose(
        ours[4]["var"].data, f.var(axis=(0, 1)), rtol=1e-5
    )


def test_fused_plan_equal_to_jax():
    """Both packages build the same mask stack, bit for bit, and the
    same per-UDF specs for the five UDFs."""
    data = _data()
    jprep = JaxUDFRunner(_udfs(libertem_tpu))._prepare(
        JaxMemoryDataSet(data=data, sig_dims=2), None, None, None
    )
    theirs = fused_plan_from_numpy(
        jprep["fused"]["masks_t"], jprep["fused"]["specs"]
    )
    ours = UDFRunner(_udfs(port))._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu")
    )["fused"]
    assert ours.masks_t.dtype == theirs.masks_t.dtype == np.float32
    assert np.array_equal(ours.masks_t, theirs.masks_t)
    assert ours.masks_t.shape == (6, SIG[0] * SIG[1])
    assert ours.specs == theirs.specs
    assert (ours.need_var, ours.need_colsum) == (
        theirs.need_var, theirs.need_colsum
    )


def test_blocks_equal_to_jax():
    """Partition.gen_blocks: same zero-padded blocks, offsets and
    valid counts as the JAX package's, block for block."""
    from libertem_tpu.io.tiling import Negotiator as JaxNegotiator
    from libertem_tpu.common.shape import Shape as JaxShape

    data = _data()
    ds = MemoryDataSet(data=data, sig_dims=2, num_partitions=3)
    jds = JaxMemoryDataSet(data=data, sig_dims=2, num_partitions=3)
    scheme = Negotiator().get_scheme([], ds.shape, np.float32, 40)
    jscheme = JaxNegotiator().get_scheme(
        [], JaxShape(NAV + SIG, sig_dims=2), np.float32,
        max_partition_frames=40,
    )
    assert scheme.depth == jscheme.depth == 40
    pairs = zip(ds.get_partitions(), jds.get_partitions())
    n = 0
    for p, jp in pairs:
        assert (p.start_frame, p.num_frames) == (
            jp.start_frame, jp.num_frames
        )
        for b, jb in zip(p.gen_blocks(scheme), jp.gen_blocks(jscheme)):
            assert np.array_equal(b.data, jb.data)
            assert (b.global_offset, b.valid) == (
                jb.global_offset, jb.valid
            )
            n += 1
    assert n == 9


def test_udf_without_process_method_raises():
    """A UDF with no process_* method is refused with TypeError, as
    the JAX package's UDF.get_method refuses it."""
    class NoProcessUDF(port.udf.UDF):
        def get_result_buffers(self):
            return {"x": self.buffer(kind="nav")}

    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=_data(), sig_dims=2)
    with pytest.raises(TypeError, match="process_tile"):
        ctx.run_udf(ds, [port.SumUDF(), NoProcessUDF()])
    with pytest.raises(TypeError, match="process_tile"):
        JaxContext(executor=InlineJobExecutor()).run_udf(
            JaxMemoryDataSet(data=_data(), sig_dims=2),
            [libertem_tpu.udf.SumUDF(), _jax_no_process_udf()],
        )


def _jax_no_process_udf():
    class NoProcessUDF(libertem_tpu.udf.base.UDF):
        def get_result_buffers(self):
            return {"x": self.buffer(kind="nav")}

    return NoProcessUDF()


@pytest.mark.parametrize("fmt", ["memory", "raw"])
@pytest.mark.parametrize("max_bytes", [None, 48 * 1024])
def test_partitions_like_jax(tmp_path, monkeypatch, fmt, max_bytes):
    """Context.load without num_partitions: at least 4 partitions and
    otherwise the byte rule, partition for partition as the JAX
    package's Context.load (here also with a partition size of 48 KiB,
    so the byte rule decides: 256 frames of 2 KiB make 11)."""
    import libertem_tpu.io.dataset.base as jax_base
    import libertem_tpu_torch.io.dataset.base as port_base

    if max_bytes is not None:
        monkeypatch.setattr(jax_base, "MAX_PARTITION_SIZE", max_bytes)
        monkeypatch.setattr(port_base, "MAX_PARTITION_SIZE", max_bytes)
    data = _data()
    if fmt == "memory":
        kw = dict(data=data, sig_dims=2)
    else:
        path = tmp_path / "scan.raw"
        data.tofile(path)
        kw = dict(path=str(path), dtype="uint16", nav_shape=NAV,
                  sig_shape=SIG)
    ours = port.Context(device="cpu").load(fmt, **kw)
    theirs = JaxContext(executor=InlineJobExecutor()).load(fmt, **kw)
    spans = [(p.start_frame, p.num_frames) for p in ours.get_partitions()]
    assert spans == [
        (p.start_frame, p.num_frames) for p in theirs.get_partitions()
    ]
    assert len(spans) == (4 if max_bytes is None else 11)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Context()


def test_cpu_run_launches_no_kernel():
    before = fused_moments.launches
    ctx = port.Context(device="cpu")
    ctx.run_udf(ctx.load("memory", data=_data(), sig_dims=2),
                port.SumUDF())
    assert fused_moments.launches == before


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in neither jax nor the
    JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import libertem_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or\n"
        "       k.startswith(('jax.', 'libertem_tpu.'))\n"
        "       or k == 'libertem_tpu']\n"
        "assert not bad, bad\n"
        "walked = {'udf.host', 'ops.sparse_masks', 'common.sparse',\n"
        "          'udf.masks', 'masks', 'common.buffers', 'api',\n"
        "          'ops.ablation', 'common.progress',\n"
        "          'common.exceptions', 'analysis', 'analysis.clust',\n"
        "          'analysis.com', 'analysis.fft', 'viz.base',\n"
        "          'udf.auto', 'udf.record', 'udf.blobfinder',\n"
        "          'udf.holography', 'utils', 'utils.generate',\n"
        "          'io.utils', 'io.dataset.base', 'io.dataset.raw',\n"
        "          'io.dataset.memory', 'io.corrections', 'ops.decode',\n"
        "          'io.dataset.decode', 'io.dataset.utils', 'io.dataset.mib',\n"
        "          'io.dataset.dm', 'io.dataset.k2is', 'io.dataset.frms6',\n"
        "          'io.dataset.seq', 'io.dataset.tvips', 'io.dataset.blo',\n"
        "          'io.dataset.empad', 'io.dataset.npy', 'io.dataset.mrc',\n"
        "          'io.dataset.ser', 'io.dataset.hdf5', 'io.dataset.raw_csr',\n"
        "          'io.dataset.dask', 'io.dataset.live', 'warnings'}\n"
        "missing = {m for m in walked if 'libertem_tpu_torch.' + m\n"
        "           not in sys.modules}\n"
        "assert not missing, missing\n"
        "assert 'defusedxml' not in sys.modules\n"
        "# h5py is imported when an HDF5 file is opened, not before\n"
        "assert 'h5py' not in sys.modules\n"
        "# nothing is built at import\n"
        "assert sys.modules['libertem_tpu_torch.ops.decode']._lib is None\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-c", code], check=True, env=env, cwd=REPO,
        timeout=120,
    )
