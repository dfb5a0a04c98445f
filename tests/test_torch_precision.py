"""The reduced-precision products of the port against the JAX
package's, on the CPU.

``LIBERTEM_TPU_TORCH_MATMUL_PRECISION=highest|default`` (the JAX
package's ``LIBERTEM_TPU_MATMUL_PRECISION``) is read once a run, in
``UDFRunner._prepare``, and handed to the fused kernel (one TF32 pass
under ``default``) and to ApplyMasks' generic product (TF32 allowed
under ``default``); on the CPU both packages ignore it, so their
results agree in both modes.  ``ApplyMasksUDF(use_bf16=True)`` rounds
both operands to bfloat16 and sums in float32, outside the fused pass.
The run plan that processes of a ``torch.distributed`` group agree on
carries the precision.  On import the port raises glibc's mmap
threshold unless ``LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE`` is set.

Tolerances: rtol 1e-5 with an absolute floor of 1e-5 of the largest
magnitude (float32 sums in another order on each side; the products
of bf16 values are exact in float32).  The one-pass kernel itself is
checked on the card in ``tests/test_torch_kernels_cuda.py``.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libertem_tpu.api as japi
import libertem_tpu.udf as judf
from libertem_tpu.executor.inline import InlineJobExecutor as JaxInline

import libertem_tpu_torch as port
import libertem_tpu_torch.ops.moments as pmoments
import libertem_tpu_torch.udf.base as pbase
import libertem_tpu_torch.udf.masks as pmasks

torch.set_num_threads(1)

RTOL = 1e-5
NAV, SIG = (6, 8), (32, 32)
PORT_ENV = "LIBERTEM_TPU_TORCH_MATMUL_PRECISION"
JAX_ENV = "LIBERTEM_TPU_MATMUL_PRECISION"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _data(kind="f32", seed=11):
    rng = np.random.default_rng(seed)
    if kind == "u16":
        return rng.poisson(8.0, NAV + SIG).astype(np.uint16)
    return rng.normal(50.0, 20.0, NAV + SIG).astype(np.float32)


def _random_masks(n=3, seed=12):
    return [m for m in np.random.default_rng(seed).random(
        (n,) + SIG).astype(np.float32)]


def _spot_masks(seed=13):
    """Random values on 4 x 8 pixels at two corners of the frame: a
    stack whose support is 2 of the frame's 8 128-pixel blocks, which
    the CPU compacts."""
    rng = np.random.default_rng(seed)
    out = []
    for corner in ((slice(0, 4), slice(0, 8)), (slice(28, 32),
                                                 slice(24, 32))):
        m = np.zeros(SIG, np.float32)
        m[corner] = rng.random((4, 8))
        out.append(m)
    return out


def _runs(data, udfs_of, monkeypatch, precision, roi=None):
    """The same UDFs through the port and the JAX package with both
    packages' precision set to ``precision``."""
    monkeypatch.setenv(PORT_ENV, precision)
    monkeypatch.setenv(JAX_ENV, precision)
    pctx = port.Context(device="cpu")
    jctx = japi.Context(executor=JaxInline())
    got = pctx.run_udf(pctx.load("memory", data=data, sig_dims=2),
                       udfs_of(port), roi=roi)
    want = jctx.run_udf(jctx.load("memory", data=data, sig_dims=2),
                        udfs_of(judf), roi=roi)
    return pctx, got, want


def _buffers(res) -> dict:
    res = res if isinstance(res, (list, tuple)) else [res]
    return {(i, k): np.asarray(r[k].data) for i, r in enumerate(res)
            for k in r}


# -- the precision switch ------------------------------------------------------


def test_precision_env_flips_between_runs(monkeypatch):
    """The counterpart of the JAX package's test: the precision that
    ``_fused_step`` hands to ``fused_moments`` follows the environment
    at the start of each run."""
    seen = []
    real = pbase.fused_moments

    def spy(*a, **kw):
        seen.append(kw.get("precision", "MISSING"))
        return real(*a, **kw)

    monkeypatch.setattr(pbase, "fused_moments", spy)
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=_data(), sig_dims=2, num_partitions=2)
    udf = port.ApplyMasksUDF(
        mask_factories=[lambda: np.ones(SIG, np.float32)])
    for precision in ("highest", "default", "highest"):
        seen.clear()
        monkeypatch.setenv(PORT_ENV, precision)
        ctx.run_udf(ds, udf)
        assert ctx.run_info["fused"]
        assert ctx.run_info["matmul_precision"] == precision
        assert seen and all(p == precision for p in seen), seen
    # unset, or any other value: "highest", as the JAX package reads it
    for value in (None, "HIGH", "fast"):
        seen.clear()
        if value is None:
            monkeypatch.delenv(PORT_ENV)
        else:
            monkeypatch.setenv(PORT_ENV, value)
        ctx.run_udf(ds, udf)
        assert seen and all(p == "highest" for p in seen), seen
    # the JAX package's variable does not steer the port
    seen.clear()
    monkeypatch.setenv(JAX_ENV, "default")
    ctx.run_udf(ds, udf)
    assert seen and all(p == "highest" for p in seen), seen


def test_precision_latched_once_a_run(monkeypatch):
    """A change of the environment inside a run takes effect at the
    next run: every block of the run keeps the precision it started
    with."""
    seen = []
    real = pbase.fused_moments

    def spy(*a, **kw):
        seen.append(kw["precision"])
        return real(*a, **kw)

    monkeypatch.setattr(pbase, "fused_moments", spy)
    monkeypatch.setenv(PORT_ENV, "default")
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=_data(), sig_dims=2, num_partitions=3)
    gen = ctx.run_udf_iter(ds, [port.SumUDF(), port.StdDevUDF()])
    next(gen)
    monkeypatch.setenv(PORT_ENV, "highest")
    for _ in gen:
        pass
    assert len(seen) >= 3 and set(seen) == {"default"}, seen
    seen.clear()
    ctx.run_udf(ds, port.SumUDF())
    assert seen and set(seen) == {"highest"}, seen


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_fused_path_like_jax(monkeypatch, precision, kind):
    """The fused pass (ApplyMasks with random masks, CoM, Sum, SumSig,
    StdDev) in both packages at both precisions: equal within rtol
    1e-5 (the CPU runs float32 products in either mode)."""
    stack = _random_masks()

    def udfs(lib):
        return [lib.ApplyMasksUDF(mask_factories=[lambda m=m: m
                                                  for m in stack]),
                lib.CoMUDF.with_params(cy=8, cx=8, r=6),
                lib.SumUDF(), lib.SumSigUDF(), lib.StdDevUDF()]

    pctx, got, want = _runs(_data(kind), udfs, monkeypatch, precision)
    assert pctx.run_info["fused"]
    assert pctx.run_info["matmul_precision"] == precision
    want = _buffers(want)
    for key, arr in _buffers(got).items():
        _close(arr, want[key])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_generic_apply_masks_like_jax(monkeypatch, precision):
    """ApplyMasks on the generic path (beside LogsumUDF, which has no
    fused form) in both packages at both precisions, and the TF32 flag
    its product runs under: allowed under ``default`` only."""
    flags = []
    real = pmasks._tf32_matmul

    def spy(allow):
        flags.append(allow)
        return real(allow)

    monkeypatch.setattr(pmasks, "_tf32_matmul", spy)
    stack = _random_masks()

    def udfs(lib):
        return [lib.ApplyMasksUDF(mask_factories=[lambda m=m: m
                                                  for m in stack]),
                lib.LogsumUDF()]

    pctx, got, want = _runs(_data(), udfs, monkeypatch, precision)
    assert not pctx.run_info["fused"]
    assert flags and set(flags) == {precision == "default"}, flags
    _close(got[0]["intensity"].data, want[0]["intensity"].data)
    _close(got[1]["logsum"].data, want[1]["logsum"].data)


# -- use_bf16 ------------------------------------------------------------------


@pytest.mark.parametrize("stack_kind", ["dense", "compacted"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_use_bf16_like_jax(monkeypatch, stack_kind, precision):
    """``use_bf16=True`` in both packages on float32 data with random
    masks: equal within rtol 1e-5 (the products of the rounded operands
    are exact, only the order of the float32 sums differs), a float32
    result off the fused pass, not within 1e-7 of the float32 run, and
    within 1e-5 of the float64 product of the bf16-rounded operands.
    The compacted stack runs on its support blocks."""
    stack = _random_masks() if stack_kind == "dense" else _spot_masks()
    data = _data()

    def udfs(lib, bf16=True):
        return [lib.ApplyMasksUDF(
            mask_factories=[lambda m=m: m for m in stack], use_bf16=bf16)]

    pctx, got, want = _runs(data, udfs, monkeypatch, precision)
    assert not pctx.run_info["fused"]
    a = got[0]["intensity"].data
    assert a.dtype == np.float32
    _close(a, want[0]["intensity"].data)
    f32 = pctx.run_udf(pctx.load("memory", data=data, sig_dims=2),
                       udfs(port, bf16=False))
    assert pctx.run_info["fused"]
    b = f32[0]["intensity"].data
    assert not np.allclose(a, b, rtol=1e-7)  # really ran in bf16
    _close(a, b, rtol=1e-2)

    def bf16(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(
            torch.bfloat16).double().numpy()

    flat = bf16(data.reshape(-1, SIG[0] * SIG[1]))
    ops = bf16(np.stack(stack).reshape(len(stack), -1))
    _close(a.reshape(-1, len(stack)), flat @ ops.T)


def test_use_bf16_compacts_the_sparse_stack():
    """The compacted bf16 product runs on the support blocks (the CPU
    compacts up to a fill of 0.5), with the dense product's result."""
    data = _data()
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2)
    udf = port.ApplyMasksUDF(mask_factories=[lambda m=m: m
                                             for m in _spot_masks()],
                             use_bf16=True)
    res = ctx.run_udf(ds, udf)
    assert udf._compact_op is not None
    flat = torch.from_numpy(data.reshape(-1, SIG[0] * SIG[1]))
    ops = torch.from_numpy(np.stack(_spot_masks()).reshape(2, -1).T.copy())
    want = pmasks.bf16_product(flat, ops).numpy()
    _close(res["intensity"].data.reshape(-1, 2), want)


def test_use_bf16_out_of_the_fused_pass():
    """``fused_moments_spec`` is None with ``use_bf16``, so the run's
    other UDFs take the generic path with it, as in the JAX package."""
    data = _data("u16")
    ctx = port.Context(device="cpu")
    ds = ctx.load("memory", data=data, sig_dims=2)
    res = ctx.run_udf(ds, [
        port.ApplyMasksUDF(mask_factories=[lambda: _random_masks(1)[0]],
                           use_bf16=True),
        port.SumUDF()])
    assert not ctx.run_info["fused"]
    assert np.array_equal(res[1]["intensity"].data,
                          data.sum(axis=(0, 1)).astype(np.float32))


def test_bf16_product_keeps_float32_output():
    """On the CPU a bf16 matmul would return bf16: the product widens
    the rounded operands instead, so its output keeps float32 digits."""
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.random((5, 300)).astype(np.float32) * 100)
    masks = torch.from_numpy(rng.random((300, 2)).astype(np.float32))
    y = pmasks.bf16_product(flat, masks)
    assert y.dtype == torch.float32
    want = flat.to(torch.bfloat16).double() @ masks.to(torch.bfloat16
                                                       ).double()
    _close(y.numpy(), want.numpy())
    assert not torch.equal(y, y.to(torch.bfloat16).to(torch.float32))


# -- fused_moments' precision argument -----------------------------------------


def test_fused_moments_precision_dispatch(monkeypatch):
    """A tensor off the CPU goes to the kernel with 1 pass under
    ``default`` and 3 under ``highest``; no precision reads the
    environment at the call; another value raises.  A CPU tensor runs
    the plain version in either mode, as XLA on the CPU ignores the
    precision."""
    calls = []

    def kernel(x, masks_t, valid, compute_var, grid=None, passes=3):
        calls.append(passes)

    monkeypatch.setattr(pmoments, "_fused_moments_cuda", kernel)
    x = torch.empty((4, 128), dtype=torch.uint16, device="meta")
    m = torch.empty((2, 128), dtype=torch.float32, device="meta")
    pmoments.fused_moments(x, m, 4, precision="default")
    pmoments.fused_moments(x, m, 4, precision="highest")
    monkeypatch.setenv(PORT_ENV, "default")
    pmoments.fused_moments(x, m, 4)
    monkeypatch.delenv(PORT_ENV)
    pmoments.fused_moments(x, m, 4)
    assert calls == [1, 3, 1, 3]
    with pytest.raises(ValueError, match="precision"):
        pmoments.fused_moments(x, m, 4, precision="fast")
    rng = np.random.default_rng(2)
    xc = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    mc = torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32))
    for a, b in zip(pmoments.fused_moments(xc, mc, 12, precision="default"),
                    pmoments.fused_moments_reference(xc, mc, 12)):
        assert torch.equal(a, b)


def test_tf32_round():
    """Round to 10 mantissa bits, to nearest, ties away from zero: the
    kernel's hi operand, the same as a numpy model of it."""
    rng = np.random.default_rng(8)
    v = np.concatenate([rng.normal(size=1000).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, 3000.3, 2049.0,
                                    -2049.0, 65535.0, 1 + 2 ** -11,
                                    1 + 3 * 2 ** -11])])
    got = pmoments.tf32_round(torch.from_numpy(v)).numpy()
    bits = v.view(np.uint32).astype(np.uint64)
    want = (((bits + 0x1000) & 0xffffe000) & 0xffffffff).astype(
        np.uint32).view(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[-6] == 3000.0 and got[-5] == 2050.0 and got[-4] == -2050.0
    assert got[-2] == np.float32(1 + 2 ** -10)  # a tie, away from zero
    assert np.all(np.abs(got - v) <= np.abs(v) * 2.0 ** -11)
    # counts below 2^11 and 0/1 masks are TF32 already: one pass
    counts = torch.from_numpy(rng.poisson(8.0, (64, 256)).astype(np.uint16))
    binary = torch.from_numpy((rng.random((2, 256)) < 0.5).astype(
        np.float32))
    assert pmoments.tf32_passes(counts, binary) == 1
    assert torch.equal(pmoments.tf32_round(counts), counts.float())


@pytest.mark.parametrize("kind", ["u16 wide", "f32"])
def test_one_pass_model_within_bound(kind):
    """The one-pass product modelled on the CPU (the plain version on
    TF32-rounded operands) lies within 2^-9 of ``|x| @ |m|`` of the
    float64 product: the bound the card's one-pass results are held
    to."""
    rng = np.random.default_rng(9)
    if kind == "u16 wide":
        x = rng.integers(0, 65536, (64, 2048)).astype(np.uint16)
    else:
        x = rng.normal(1000.0, 300.0, (64, 2048)).astype(np.float32)
    m = rng.normal(size=(6, 2048)).astype(np.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    y = pmoments.fused_moments_reference(
        pmoments.tf32_round(xt), pmoments.tf32_round(mt), 64)[0].double()
    x64, m64 = xt.double(), mt.double()
    err = (y - x64 @ m64.T).abs()
    bound = 2.0 ** -9 * (x64.abs() @ m64.abs().T)
    assert bool(torch.all(err <= bound))
    # and the one pass is not the float32 product
    assert not torch.allclose(
        y, pmoments.fused_moments_reference(xt, mt, 64)[0].double(),
        rtol=1e-6)


# -- several processes agree on the precision -----------------------------------

RANK_SCRIPT = r"""
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist
import libertem_tpu_torch as port
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor

rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
seen = []
try:
    ctx = port.Context(executor=ShardedJobExecutor(devices=["cpu"]))
    data = np.random.default_rng(3).poisson(8.0, (8, 8, 16, 16)).astype(
        np.uint16)
    ds = ctx.load("memory", data=data, sig_dims=2)
    for precision in (sys.argv[5], "default"):
        os.environ["LIBERTEM_TPU_TORCH_MATMUL_PRECISION"] = precision
        try:
            res = ctx.run_udf(ds, [port.SumUDF(), port.StdDevUDF()])
            seen.append([None, ctx.run_info["matmul_precision"],
                         bool(np.array_equal(res[0]["intensity"].data,
                                             data.sum(axis=(0, 1))))])
        except port.UDFException as e:
            seen.append([str(e), None, None])
finally:
    with open(out, "w") as f:
        json.dump(seen, f)
    dist.destroy_process_group()
"""


def test_run_plan_digest_carries_precision(tmp_path):
    """Two processes of a gloo group whose precision differs: the run
    raises on both, naming ``matmul_precision``; the next run, with
    the same precision on both, goes on."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop(PORT_ENV, None)
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), "2",
         str(tmp_path / "pg"), outs[r], ("default", "highest")[r]],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    for out in outs:
        with open(out) as f:
            (err, _, _), (err2, precision, right) = json.load(f)
        assert err is not None and "run plan differs" in err
        assert "matmul_precision" in err
        assert err2 is None and precision == "default" and right


# -- the malloc tune ------------------------------------------------------------


def test_setup_malloc_honours_its_opt_out(monkeypatch):
    """``_setup_malloc`` calls glibc's ``mallopt(M_MMAP_THRESHOLD,
    1 GiB)`` on Linux unless ``LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE`` is
    set; elsewhere, or where the call fails, it does nothing."""
    calls = []

    class Libc:
        def mallopt(self, param, value):
            calls.append(("mallopt", param, value))
            return 1

    def cdll(name, **kw):
        calls.append(("CDLL", name))
        return Libc()

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(sys, "platform", "linux")
    monkeypatch.setenv("LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE", "1")
    port._setup_malloc()
    assert calls == []
    # the JAX package's opt-out does not steer the port
    monkeypatch.delenv("LIBERTEM_TPU_TORCH_NO_MALLOC_TUNE")
    monkeypatch.setenv("LIBERTEM_TPU_NO_MALLOC_TUNE", "1")
    port._setup_malloc()
    assert calls == [("CDLL", "libc.so.6"), ("mallopt", -3, 1 << 30)]
    calls.clear()
    monkeypatch.setattr(sys, "platform", "darwin")
    port._setup_malloc()
    assert calls == []

    def broken(name, **kw):
        raise OSError("no libc")

    monkeypatch.setattr(sys, "platform", "linux")
    monkeypatch.setattr(ctypes, "CDLL", broken)
    port._setup_malloc()  # a hint to the allocator: a failure is ignored
