"""Sparse mask stacks, block compaction, aux buffers with mask shifts,
and complex data and masks in the port, against the JAX package on the
CPU.

The same seeded numpy inputs go through both packages.  Compaction
plans (support, block count, compacted operand) and the mask factories
are equal bit for bit; float32 device results agree within rtol 1e-5
(other summation orders) with an absolute floor of 1e-5 of the
buffer's largest magnitude; complex64 results within 1e-4 relative to
the largest magnitude.  The goldens ``mask_shifts``,
``mask_stack_sparse`` and ``radial_fourier`` are held at the
tolerances of ``tests/test_parity_reference.py``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import golden_common as gc
import libertem_tpu
import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
from libertem_tpu import masks as jax_masks
from libertem_tpu.api import Context as JaxContext
from libertem_tpu.executor.inline import InlineJobExecutor
from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemoryDataSet
from libertem_tpu.ops import sparse_masks as jax_sparse
from libertem_tpu.udf.base import UDFRunner as JaxUDFRunner
from test_parity_reference import _golden

import libertem_tpu_torch as port
from libertem_tpu_torch import masks as port_masks
from libertem_tpu_torch.io.dataset.memory import MemoryDataSet
from libertem_tpu_torch.ops import sparse_masks as port_sparse
from libertem_tpu_torch.ops.moments import fused_moments
from libertem_tpu_torch.udf.base import UDFRunner

torch.set_num_threads(1)

RTOL = 1e-5
CRTOL = 1e-4
JUDF = libertem_tpu.udf.base.UDF
PUDF = port.udf.UDF


def _counts(shape=(6, 5, 32, 32), seed=0):
    return np.random.default_rng(seed).poisson(8.0, shape).astype(
        np.uint16)


def _run_both(data, ours_udfs, theirs_udfs, num_partitions=2, **kw):
    ctx = port.Context(device="cpu")
    ours = ctx.run_udf(ctx.load("memory", data=data, sig_dims=2,
                                num_partitions=num_partitions),
                       ours_udfs, **kw)
    theirs = JaxContext(executor=InlineJobExecutor()).run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2,
                         num_partitions=num_partitions),
        theirs_udfs, **kw,
    )
    return ours, theirs


def _compare(ours, theirs, rtol=RTOL):
    if isinstance(theirs, dict):
        ours, theirs = [ours], [theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for name in b:
            x = np.asarray(a[name].data)
            y = np.asarray(b[name].data)
            assert x.shape == y.shape and x.dtype == y.dtype, name
            scale = max(float(np.nanmax(np.abs(y), initial=0.0)), 1.0)
            np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol * scale,
                                       err_msg=name)


# -- compaction plan and gather -------------------------------------------------

def _stacks():
    rng = np.random.default_rng(0)
    tail = np.zeros((5, 1000), dtype=np.float32)
    tail[0, 130:140] = rng.random(10)
    tail[3, 900:950] = rng.random(50)
    temps = jax_masks.sparse_template_multi_stack(
        mask_index=np.arange(16), offsetY=rng.integers(26, 36, 16),
        offsetX=rng.integers(20, 40, 16),
        template=np.ones((3, 3), np.float32), imageSizeY=64, imageSizeX=64,
    )
    disks = jax_masks.sparse_circular_multi_stack(
        np.arange(16), np.repeat([46, 58, 70, 82], 4),
        np.tile([46, 58, 70, 82], 4), 128, 128, 4,
    )
    return {
        "tail block": tail,
        "templates": np.asarray(temps).reshape(16, -1).astype(np.float32),
        "disks": np.concatenate([
            jax_masks.circular(64, 64, 128, 128, 16)[None],
            np.asarray(disks),
        ]).reshape(17, -1).astype(np.float32),
        "rings": np.asarray(jax_masks.radial_bins(
            31.5, 31.5, 64, 64, radius=30, n_bins=4)).reshape(4, -1),
        "zero": np.zeros((2, 256), dtype=np.float32),
        "complex": (np.asarray(temps).reshape(16, -1)
                    * np.exp(1j * np.arange(64 * 64) / 50)).astype(
            np.complex64),
    }


@pytest.mark.parametrize("name", list(_stacks()))
def test_plan_compaction_equal_to_jax(name):
    stack = _stacks()[name]
    ours = port_sparse.plan_compaction(stack)
    theirs = jax_sparse.plan_compaction(stack)
    assert (ours is None) == (theirs is None)
    if name == "rings":
        assert ours is None
        return
    assert set(ours) == set(theirs)
    for key in ("support", "operand_c"):
        assert ours[key].dtype == theirs[key].dtype, key
        assert np.array_equal(ours[key], theirs[key]), key
    assert (ours["n_blocks"], ours["block"], ours["fill"]) == (
        theirs["n_blocks"], theirs["block"], theirs["fill"])
    if name == "disks":
        # rows 42..86 of a 128x128 frame: 45 of 128 blocks
        assert ours["support"].tolist() == list(range(42, 87))


@pytest.mark.parametrize("dtype", ["uint16", "float32", "int64",
                                   "complex64"])
@pytest.mark.parametrize("pixels", [1000, 4096])
def test_gather_blocks_equal_to_jax(dtype, pixels):
    import jax.numpy as jnp

    rng = np.random.default_rng(pixels)
    x = (rng.poisson(8.0, (24, pixels)) * (1 + 1j if dtype == "complex64"
                                           else 1)).astype(dtype)
    nb = -(-pixels // 128)
    support = np.sort(rng.choice(nb, 5, replace=False)).astype(np.int32)
    support[-1] = nb - 1  # the tail block, when there is one
    ours = port_sparse.gather_blocks(torch.from_numpy(x), support)
    theirs = np.asarray(jax_sparse.gather_blocks(jnp.asarray(x), support))
    assert ours.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(ours.numpy(), theirs)


# -- mask factories ----------------------------------------------------------------

FACTORIES = {
    "rectangular": lambda m: m.rectangular(3, 40, 20, -12, 64, 48),
    "rectangular empty": lambda m: m.rectangular(3, 4, 0, 5, 64, 48),
    "radial_gradient": lambda m: m.radial_gradient(30.5, 20, 64, 48, 15),
    "radial_gradient aa": lambda m: m.radial_gradient(
        30.5, 20, 64, 48, 15, antialiased=True),
    "polar_map": lambda m: np.stack(m.polar_map(30.5, 20, 64, 48)),
    "polar_map stretched": lambda m: np.stack(m.polar_map(
        30.5, 20, 64, 48, stretchY=1.3, angle=0.4)),
    "bounding_radius": lambda m: np.array(m.bounding_radius(30.5, 20, 64,
                                                            48)),
    "radial_bins": lambda m: m.radial_bins(31.5, 23.5, 64, 48, radius=30,
                                           n_bins=6),
    "radial_bins sparse": lambda m: m.radial_bins(
        31.5, 23.5, 64, 48, radius=30, radius_inner=3, n_bins=40,
        normalize=True),
    "background_subtraction": lambda m: m.background_subtraction(
        30, 22, 64, 48, 18, 9),
    "radial_gradient_background_subtraction": lambda m:
        m.radial_gradient_background_subtraction(
            m.polar_map(30, 22, 64, 48)[0], 10, 20, delta=2.0),
    "sparse_template_multi_stack": lambda m: m.sparse_template_multi_stack(
        np.arange(5), [0, 10, 60, -2, 30], [3, 44, 5, 20, -1],
        np.arange(12, dtype=np.float32).reshape(3, 4), 64, 48),
    "sparse_circular_multi_stack": lambda m: m.sparse_circular_multi_stack(
        np.arange(4), [10, 20, 30, 62], [5, 25, 45, 40], 64, 48, 3.5),
    "balance": lambda m: m.balance(np.array([[2, -1, 0], [3, -4, 1]])),
}


@pytest.mark.parametrize("name", list(FACTORIES))
def test_mask_factories_equal_to_jax(name):
    ours = FACTORIES[name](port_masks)
    theirs = FACTORIES[name](jax_masks)
    assert type(ours).__name__ == type(theirs).__name__
    assert np.asarray(ours).dtype == np.asarray(theirs).dtype
    assert np.array_equal(np.asarray(ours), np.asarray(theirs))
    if hasattr(theirs, "todense"):
        assert np.array_equal(ours.sum(axis=0).todense(),
                              theirs.sum(axis=0).todense())


# -- sparse stacks on both paths ---------------------------------------------------

def _disk_stack(lib, sig=32):
    c = [sig // 2 - 6, sig // 2 - 2, sig // 2 + 2, sig // 2 + 6]
    return lib.masks.sparse_circular_multi_stack(
        np.arange(16), np.repeat(c, 4), np.tile(c, 4), sig, sig, 1.5)


def _sparse_udfs(lib):
    return [
        lib.udf.ApplyMasksUDF(mask_factories=[
            lambda: lib.masks.circular(16, 16, 32, 32, 4)]),
        lib.udf.ApplyMasksUDF(mask_factories=lambda: _disk_stack(lib),
                              mask_count=16),
    ]


def test_fused_plan_compacts_like_jax():
    data = _counts()
    prep = UDFRunner(_sparse_udfs(port))._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    jprep = JaxUDFRunner(_sparse_udfs(libertem_tpu))._prepare(
        JaxMemoryDataSet(data=data, sig_dims=2), None, None, None)
    ours, theirs = prep["fused"].compaction, jprep["fused"]["compaction"]
    assert ours is not None and theirs is not None
    for key in ("support", "operand_c"):
        assert np.array_equal(ours[key], theirs[key])
    assert ours["n_blocks"] == theirs["n_blocks"] == 8
    assert np.array_equal(prep["masks_t"].numpy(), ours["operand_c"].T)
    assert np.array_equal(prep["fused"].masks_t, jprep["fused"]["masks_t"])
    before = fused_moments.launches
    res, jres = _run_both(data, _sparse_udfs(port),
                          _sparse_udfs(libertem_tpu), num_partitions=3)
    assert fused_moments.launches == before  # the CPU runs the plain op
    _compare(res, jres)
    flat = data.reshape(-1, 32 * 32).astype(np.float64)
    want = flat @ np.asarray(_disk_stack(port)).reshape(16, -1).T
    np.testing.assert_allclose(res[1]["intensity"].data.reshape(-1, 16),
                               want, rtol=1e-5)


@pytest.mark.parametrize("pays", [True, False])
def test_compaction_use_follows_the_device(monkeypatch, pays):
    """A run uses the plan only where compaction pays on its device (on
    a CUDA card up to ``CUDA_MAX_FILL`` of the product); either way
    ``run_info`` keeps the plan, and the results agree with the JAX
    package's on the fused and on the generic path."""
    plan = port_sparse.plan_compaction(_stacks()["disks"])
    for product in ("fused_moments", "matmul"):
        assert port_sparse.compaction_pays(plan, "cpu", product)
        assert not port_sparse.compaction_pays(None, "cpu", product)
        for limit in (plan["fill"], plan["fill"] - 1e-9):
            monkeypatch.setitem(port_sparse.CUDA_MAX_FILL, product, limit)
            assert port_sparse.compaction_pays(
                plan, torch.device("cuda"), product) == (
                limit >= plan["fill"])
    if not pays:
        import libertem_tpu_torch.udf.base as port_base
        import libertem_tpu_torch.udf.masks as port_udf_masks
        for mod in (port_base, port_udf_masks):
            monkeypatch.setattr(mod, "compaction_pays",
                                lambda *args: False)
    data = _counts(seed=7)
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2, num_partitions=2)
    res = ctx.run_udf(ds, _sparse_udfs(port))
    info = ctx.run_info
    assert info["fused"] and info["compaction"]["support"].size == 4
    assert info["compacted_blocks"] == (4 if pays else None)
    jres = JaxContext(executor=InlineJobExecutor()).run_udf(
        JaxMemoryDataSet(data=data, sig_dims=2, num_partitions=2),
        _sparse_udfs(libertem_tpu))
    _compare(res, jres)
    # the generic path of ApplyMasks (beside a UDF without a fused form)
    udfs = _sparse_udfs(port)
    res = ctx.run_udf(ds, udfs + [port.LogsumUDF()])
    assert not ctx.run_info["fused"]
    assert (udfs[1]._compact_op is not None) == pays
    _compare(res[:2], jres)


def test_generic_path_compacts_like_jax():
    """Beside a UDF without a fused form, ApplyMasks projects the
    gathered support blocks in its own process_tile (with a roi)."""
    data = _counts(seed=1)
    roi = np.random.default_rng(2).random(data.shape[:2]) > 0.3
    ours, theirs = _run_both(
        data, _sparse_udfs(port) + [port.LogsumUDF()],
        _sparse_udfs(libertem_tpu) + [libertem_tpu.udf.LogsumUDF()],
        num_partitions=3, roi=roi,
    )
    _compare(ours, theirs)


def test_scipy_sparse_factories_like_jax():
    """Factories returning scipy.sparse matrices are densified; a stack
    of them declares itself sparse."""
    data = _counts(seed=3)
    rng = np.random.default_rng(4)
    dense = np.zeros((32, 32), np.float32)
    dense[10:13, 20:23] = 1.5
    other = (rng.random((32, 32)) > 0.97).astype(np.float32)

    def udfs(lib):
        return lib.udf.ApplyMasksUDF(mask_factories=[
            lambda: sp.csr_matrix(dense), lambda: sp.coo_matrix(other)])

    udf = udfs(port)
    assert udf.masks.use_sparse == "scipy.sparse"
    ours, theirs = _run_both(data, udfs(port), udfs(libertem_tpu))
    _compare(ours, theirs)
    flat = data.reshape(-1, 32 * 32).astype(np.float64)
    want = flat @ np.stack([dense, other]).reshape(2, -1).T
    np.testing.assert_allclose(
        ours["intensity"].data.reshape(-1, 2), want, rtol=1e-5)


# -- aux buffers and mask shifts ---------------------------------------------------

def _shifts(n, seed=5):
    return np.random.default_rng(seed).integers(-3, 4, (n, 2))


def _shifted_udfs(lib, shifts, **kw):
    h = w = 32
    aux = lib.udf.base.UDF.aux_data(shifts, kind="nav", extra_shape=(2,),
                                    dtype=np.int64)
    return [
        lib.udf.ApplyMasksUDF(
            mask_factories=[lambda: lib.masks.circular(16, 16, w, h, 6),
                            lambda: lib.masks.gradient_x(w, h)],
            shifts=aux, **kw),
        lib.udf.ApplyMasksUDF(
            mask_factories=[lambda: lib.masks.ring(16, 16, w, h, 12, 6)],
            shifts=(2, -3)),
        lib.udf.SumUDF(),
    ]


def _shifted_oracle(data, masks, shifts):
    """Each frame moved by (-dy, -dx), zeros shifted in, then
    projected: ``frame[r + dy, c + dx]`` at (r, c)."""
    n, h, w = data.shape
    out = np.zeros((n, len(masks)))
    for i, (dy, dx) in enumerate(np.broadcast_to(shifts, (n, 2))):
        moved = np.zeros((h, w))
        src = data[i].astype(np.float64)
        moved[max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = \
            src[max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
        out[i] = [(moved * m).sum() for m in masks]
    return out


@pytest.mark.parametrize("with_roi", [False, True])
def test_aux_shifts_like_jax(with_roi):
    data = _counts(seed=6)
    n = 30
    shifts = _shifts(n)
    kw = {}
    if with_roi:
        kw["roi"] = np.random.default_rng(7).random(data.shape[:2]) > 0.4
    ours, theirs = _run_both(data, _shifted_udfs(port, shifts),
                             _shifted_udfs(libertem_tpu, shifts),
                             num_partitions=3, **kw)
    _compare(ours, theirs)
    flat = data.reshape(n, 32, 32)
    sel = kw["roi"].reshape(-1) if with_roi else np.ones(n, bool)
    m = port.masks
    want = _shifted_oracle(flat[sel], [m.circular(16, 16, 32, 32, 6),
                                       m.gradient_x(32, 32)], shifts[sel])
    np.testing.assert_allclose(
        ours[0]["intensity"].raw_data, want, rtol=1e-5)
    want = _shifted_oracle(flat[sel], [m.ring(16, 16, 32, 32, 12, 6)],
                           np.array([2, -3]))
    np.testing.assert_allclose(ours[1]["intensity"].raw_data, want,
                               rtol=1e-5)


def test_aux_shifts_on_host_engine_like_jax():
    """mask_dtype float64: the shifted projection runs on the host
    engine, in float64 on both sides."""
    data = _counts(seed=8)
    shifts = _shifts(30, seed=9)
    ours, theirs = _run_both(
        data, _shifted_udfs(port, shifts, mask_dtype=np.float64)[:1],
        _shifted_udfs(libertem_tpu, shifts, mask_dtype=np.float64)[:1],
    )
    assert ours[0]["intensity"].data.dtype == np.float64
    _compare(ours, theirs, rtol=1e-12)


def _aux_reader(base, xp_name, kind):
    """Reads its per-frame aux rows: a tile, a vmapped frame, a host
    frame."""
    class AuxReaderUDF(base):
        def get_backends(self):
            return (getattr(self, xp_name),)

        def get_result_buffers(self):
            return {"v": self.buffer(kind="nav", dtype="float32")}

    if kind == "tile":
        def process_tile(self, tile):
            self.results.v += self.params.weights * tile.sum((1, 2))
    else:
        def process_frame(self, frame):
            self.results.v = self.params.weights * frame.sum()
    setattr(AuxReaderUDF, f"process_{kind}", process_tile
            if kind == "tile" else process_frame)
    return AuxReaderUDF


@pytest.mark.parametrize("kind,engine", [
    ("tile", "device"), ("frame", "device"), ("frame", "host"),
    ("tile", "host"),
])
def test_aux_rows_reach_each_path(kind, engine):
    data = _counts(seed=10).astype(np.float32)
    weights = np.random.default_rng(11).random(30).astype(np.float32)
    roi = np.random.default_rng(12).random(data.shape[:2]) > 0.3
    names = {"device": ("BACKEND_TORCH", "BACKEND_JAX"),
             "host": ("BACKEND_NUMPY", "BACKEND_NUMPY")}[engine]

    def make(base, xp_name):
        return _aux_reader(base, xp_name, kind)(
            weights=base.aux_data(weights, kind="nav", dtype=np.float32))

    ours, theirs = _run_both(data, make(PUDF, names[0]),
                             make(JUDF, names[1]), num_partitions=3,
                             roi=roi)
    _compare(ours, theirs)
    want = weights[roi.reshape(-1)] * data.reshape(30, -1)[
        roi.reshape(-1)].sum(1)
    np.testing.assert_allclose(ours["v"].raw_data, want, rtol=1e-5)


# -- complex data and masks --------------------------------------------------------

def _complex_masks():
    h = w = 32
    r, phi = port_masks.polar_map(15.5, 15.5, w, h)
    rings = np.stack([((r >= lo) & (r < lo + 4)) for lo in (2, 6, 10, 14)])
    orders = np.arange(4)
    return (rings[:, None] * np.exp(1j * orders[:, None, None] * phi)
            ).reshape(16, h, w).astype(np.complex64)


def test_complex_masks_like_jax():
    data = _counts(seed=13)
    stack = _complex_masks()

    def udfs(lib):
        return [lib.udf.ApplyMasksUDF(mask_factories=lambda: stack,
                                      mask_count=16),
                lib.udf.SumUDF()]

    prep = UDFRunner(udfs(port))._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    assert prep["fused"] is None  # the fused plan is real only
    ours, theirs = _run_both(data, udfs(port), udfs(libertem_tpu))
    assert ours[0]["intensity"].data.dtype == np.complex64
    _compare(ours, theirs, rtol=CRTOL)
    want = data.reshape(30, -1).astype(np.float64) @ stack.reshape(
        16, -1).astype(np.complex128).T
    got = ours[0]["intensity"].raw_data
    assert np.abs(got - want).max() <= CRTOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_data_like_jax(dtype):
    rng = np.random.default_rng(14)
    data = (rng.normal(size=(5, 6, 16, 16))
            + 1j * rng.normal(size=(5, 6, 16, 16))).astype(dtype)

    def udfs(lib):
        return [lib.udf.SumUDF(), lib.udf.SumSigUDF(),
                lib.udf.ApplyMasksUDF(mask_factories=[
                    lambda: lib.masks.circular(8, 8, 16, 16, 5)])]

    prep = UDFRunner(udfs(port))._prepare(
        MemoryDataSet(data=data, sig_dims=2), torch.device("cpu"))
    # complex128 comes down to complex64 on the device
    assert prep["input_dtype"] == np.complex64
    # a complex128 dataset is an explicit 64-bit request for ApplyMasks
    assert prep["plan"][2].host is (dtype == "complex128")
    ours, theirs = _run_both(data, udfs(port), udfs(libertem_tpu))
    _compare(ours, theirs, rtol=CRTOL)
    np.testing.assert_allclose(ours[0]["intensity"].data,
                               data.sum(axis=(0, 1)), rtol=CRTOL,
                               atol=CRTOL * np.abs(data).sum(axis=(0, 1)).max())


# -- goldens ---------------------------------------------------------------------

H, W = gc.SIG
MP = gc.MASK_PARAMS
RP = gc.RADIAL_PARAMS


@pytest.fixture(scope="module")
def golden_ds():
    return MemoryDataSet(data=gc.golden_data(), sig_dims=2,
                         num_partitions=4)


def test_golden_mask_shifts(golden_ds):
    g = _golden("mask_shifts")
    aux = port.udf.UDF.aux_data(g["shift_vals"], kind="nav",
                                extra_shape=(2,), dtype=np.int64)
    res = port.Context(device="cpu").run_udf(golden_ds, port.ApplyMasksUDF(
        mask_factories=[lambda: port.masks.circular(
            MP["cx"], MP["cy"], W, H, MP["r_bf"])],
        shifts=aux,
    ))
    assert np.allclose(res["intensity"].data, g["intensity"],
                       rtol=1e-4, atol=1e-2)


def test_golden_mask_stack_sparse(golden_ds):
    g = _golden("mask_stack_sparse")
    res = port.Context(device="cpu").run_udf(golden_ds, port.ApplyMasksUDF(
        mask_factories=lambda: port.masks.radial_bins(
            RP["cx"], RP["cy"], W, H, radius=RP["ro"],
            radius_inner=RP["ri"], n_bins=RP["n_bins"]),
        mask_count=RP["n_bins"],
    ))
    assert np.allclose(res["intensity"].data, g["intensity"],
                       rtol=1e-4, atol=1e-2)


def test_golden_radial_fourier(golden_ds):
    from libertem_tpu.analysis.radialfourier import radial_fourier_masks

    g = _golden("radial_fourier")
    stack = radial_fourier_masks((H, W), RP["cx"], RP["cy"], RP["ri"],
                                 RP["ro"], RP["n_bins"], RP["max_order"])
    res = port.Context(device="cpu").run_udf(golden_ds, port.ApplyMasksUDF(
        mask_factories=lambda: stack,
        mask_count=RP["n_bins"] * (RP["max_order"] + 1),
        mask_dtype=np.complex64,
    ))
    assert res["intensity"].data.dtype == np.complex64
    assert np.allclose(res["intensity"].data, g["intensity"],
                       rtol=1e-3, atol=0.1)
