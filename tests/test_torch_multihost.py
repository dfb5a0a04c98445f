"""The port's run over several processes (counterpart of the JAX
package's multi-host branch, ``tests/test_multihost.py``; its design in
``docs/multihost.md``), on the CPU.

Two processes join one ``torch.distributed`` group over gloo
(``init_method="file://..."``, a 60 s group timeout), each with two CPU
workers (``ShardedJobExecutor(devices=["cpu", "cpu"])``), so four
global workers.  The job runs once per module: this file, run as a
script, is one rank of it,

    python tests/test_torch_multihost.py RANK WORLD INIT_FILE OUT

and writes what its rank saw to ``OUT.npz`` (and an export to
``OUT.npy``).  The same jobs (:func:`run_jobs`) run in this process
over ``["cpu"] * 4`` workers of one process, and the JAX package's
sharded run over 4 of the test configuration's virtual CPU devices.
The data: nav 16 x 16, sig 24 x 24, u16 Poisson(8) counts and float32
uniform values from a numpy seed.

Checks: both ranks' results bit for bit equal to each other and to the
one-process four-worker run (the same split, the same fold order): the
fused pass (Sum, SumSig, StdDev, ApplyMasks with two masks, CoM), every
partial of a ``run_udf_iter`` over a roi of about 60% of the frames
with its damage, a parameter patch after the first partial, the
generic path (Logsum beside Sum), the hooks' effect; against the JAX
package within the tolerances of ``test_torch_sharded.py`` (rtol 1e-5
with a floor of 1e-5 of the buffer's largest magnitude; u16 sums bit for
bit).  A numpy UDF, unequal local worker counts and a roi that differs
by rank raise ``UDFException`` on both ranks, and the job goes on; at
its end one rank leaves, and the other's next collective raises.
"""
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libertem_tpu_torch as port
from libertem_tpu_torch.common import distributed
from libertem_tpu_torch.common.exceptions import UDFException
from libertem_tpu_torch.common.progress import ProgressReporter
from libertem_tpu_torch.executor.sharded import ShardedJobExecutor

NAV = (16, 16)
SIG = (24, 24)
SEED = 14
RTOL = 1e-5
WORLD = 2
LOCAL = 2
JOB_TIMEOUT_S = 150
NUMPY_REFUSAL = (
    "numpy-backend UDFs process the host block feed, which is split "
    "across processes on a multi-host mesh — run them single-host or "
    "on an InlineJobExecutor"
)


# -- the jobs, the same in each rank and in one process --------------------


def make_data(kind: str) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    if kind == "u16":
        return rng.poisson(8.0, NAV + SIG).astype(np.uint16)
    rng = np.random.default_rng(SEED + 1)
    return rng.random(NAV + SIG, dtype=np.float32)


def masks(lib, r_ring: int = 10) -> list:
    h, w = SIG
    return [lib.masks.circular(12, 12, w, h, 5),
            lib.masks.ring(12, 12, w, h, r_ring, 6)]


def fused_udfs(lib) -> list:
    stack = masks(lib)
    return [lib.udf.SumUDF(), lib.udf.SumSigUDF(), lib.udf.StdDevUDF(),
            lib.udf.ApplyMasksUDF(mask_factories=[lambda m=m: m
                                                  for m in stack]),
            lib.udf.CoMUDF.with_params(cy=12, cx=12, r=8)]


def roi60() -> np.ndarray:
    return np.random.default_rng(SEED + 2).random(NAV) < 0.6


def hooked_udf():
    class HookedSumSigUDF(port.SumSigUDF):
        """SumSig whose postprocess doubles its shard's rows; each
        instance's hook calls go to the class's list."""
        calls = []

        def preprocess(self):
            type(self).calls.append("pre")

        def postprocess(self):
            type(self).calls.append("post")
            self.results.intensity[:] *= 2

    return HookedSumSigUDF


class CountingReporter(ProgressReporter):
    """Records the frames of its last progress update."""

    def __init__(self):
        self.complete = 0.0
        self.total = 0

    def update(self, state):
        self.complete = state.num_frames_complete
        self.total = state.num_frames_total

    def end(self, state):
        self.update(state)


def put(out: dict, key: str, results) -> None:
    """Every buffer of a run's results (SingleUDFResults, a list of
    them, or UDFResults) into ``out``."""
    bufs = [results] if isinstance(results, dict) else getattr(
        results, "buffers", results)
    for ui, b in enumerate(bufs):
        for name, buf in b.items():
            out[f"{key}/{ui}/{name}"] = np.asarray(buf.data)
    damage = getattr(results, "damage", None)
    if damage is not None:
        out[f"{key}/damage"] = np.asarray(damage.data)


def run_jobs(port, ctx) -> dict:
    """The runs whose results each rank and the one-process run must
    share: name -> array."""
    out = {}
    for kind in ("u16", "f32"):
        ds = ctx.load("memory", data=make_data(kind), sig_dims=2)
        out[f"partitions/{kind}"] = np.array(ds.get_num_partitions())
        put(out, f"fused/{kind}", ctx.run_udf(ds, fused_udfs(port)))
        out[f"fused_run/{kind}"] = np.array(ctx.run_info["fused"])
    ds = ctx.load("memory", data=make_data("f32"), sig_dims=2)
    k = 0
    for k, part in enumerate(ctx.run_udf_iter(
            ds, [port.SumSigUDF(), port.SumUDF()], roi=roi60())):
        put(out, f"iter/{k}", part)
    out["iter/count"] = np.array(k + 1)

    gen = ctx.run_udf_iter(ds, [port.ApplyMasksUDF(
        mask_factories=[lambda m=m: m for m in masks(port)]),
        port.SumUDF()])
    for i, last in enumerate(gen):
        if i == 0:
            gen.update_parameters_experimental([{"mask_factories": [
                lambda m=m: m for m in masks(port, r_ring=11)]}, {}])
    put(out, "patch", last)

    put(out, "generic", ctx.run_udf(ds, [port.LogsumUDF(), port.SumUDF()]))
    out["generic_run/fused"] = np.array(ctx.run_info["fused"])
    hooked = hooked_udf()
    put(out, "hooks", ctx.run_udf(ds, [hooked()]))
    out["hooks_calls"] = np.array(hooked.calls)
    reporter = CountingReporter()
    ctx.run_udf(ds, port.SumUDF(), progress=reporter)
    out["progress"] = np.array([reporter.complete, reporter.total])
    return out


def worker(rank: int, world: int, init_file: str, out: str) -> None:
    """One rank of the two-process job (``__main__``)."""
    import torch.distributed as dist

    import libertem_tpu_torch.executor.base as executor_base
    from libertem_tpu_torch.udf.base import UDFRunner

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        ctx = port.Context(executor=ShardedJobExecutor(
            devices=["cpu"] * LOCAL))
        res = run_jobs(port, ctx)
        res["global_workers"] = np.array(
            [[w.rank, str(w.device)] for w in ctx.executor.global_workers])
        res["local_devices"] = np.array(len(ctx.executor.devices))
        res["transport"] = np.array(str(ctx.run_info["transport"]))
        res["collective_s"] = np.array(ctx.feed_stats["collective_s"])
        ds = ctx.load("memory", data=make_data("u16"), sig_dims=2)

        os.environ["LIBERTEM_TPU_SHARDED_STATS"] = "1"
        try:
            runner = UDFRunner([port.SumUDF()])
            runner.run_for_dataset(ds, devices=["cpu"] * LOCAL)
        finally:
            del os.environ["LIBERTEM_TPU_SHARDED_STATS"]
        res["stats/transport"] = np.array(
            runner.last_sharded_stats["transport"])
        res["stats/collective_s"] = np.array(
            runner.last_sharded_stats["collective_s"])

        def refusal(fn) -> str:
            try:
                fn()
            except UDFException as e:
                return str(e)
            return "no exception"

        class NumpyMaxUDF(port.udf.UDF):
            def get_backends(self):
                return (self.BACKEND_NUMPY,)

            def get_result_buffers(self):
                return {"m": self.buffer(kind="sig", dtype="float32")}

            def process_frame(self, frame):
                np.maximum(self.results.m, frame, out=self.results.m)

            def merge(self, dest, src):
                np.maximum(dest.m, src.m, out=dest.m)

        res["refused/numpy"] = np.array(refusal(
            lambda: ctx.run_udf(ds, [port.SumUDF(), NumpyMaxUDF()])))
        res["refused/workers"] = np.array(refusal(
            lambda: ShardedJobExecutor(devices=["cpu"] * (2 - rank))))
        roi = np.ones(NAV, dtype=bool)
        roi[0, rank] = False
        res["refused/roi"] = np.array(refusal(
            lambda: ctx.run_udf(ds, port.SumUDF(), roi=roi)))
        # still in step after the refusals
        put(res, "after", ctx.run_udf(ds, port.SumUDF()))

        ctx.export_dataset(ds, path=f"{out}.npy", overwrite=True)

        # make_with builds its executor on the card: here the CPU
        real = executor_base.resolve_device
        executor_base.resolve_device = lambda d=None: torch.device(
            "cpu") if d is None else real(d)
        try:
            mctx = port.Context.make_with("sharded")
        finally:
            executor_base.resolve_device = real
        res["make_with/global"] = np.array(
            len(mctx.executor.global_workers))
        res["make_with/partitions"] = np.array(mctx.load(
            "memory", data=make_data("u16"), sig_dims=2).get_num_partitions())
        put(res, "make_with/sum", mctx.run_udf(
            mctx.load("memory", data=make_data("u16"), sig_dims=2),
            port.SumUDF()))
        res["jax_imported"] = np.array("jax" in sys.modules)
        dist.barrier()
        if rank == 1:
            # leaves: rank 0's next collective meets its absence
            np.savez(f"{out}.npz", **res)
            return
        res["refused/absent"] = np.array(refusal(
            lambda: ShardedJobExecutor(devices=["cpu"] * LOCAL)))
        np.savez(f"{out}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# -- the tests ------------------------------------------------------------

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.nanmax(np.abs(b), initial=0.0)), 1.0)
    assert np.allclose(a, b, rtol=rtol, atol=rtol * scale, equal_nan=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's arrays (and its export's path), from one run of the
    two-process job."""
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [str(tmp / f"rank{r}") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(tmp / "pg"), outs[r]],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(f"{o}.npz"), export=f"{o}.npy") for o in outs]


@pytest.fixture(scope="module")
def single():
    """The same jobs in one process over four CPU workers."""
    ctx = port.Context(executor=ShardedJobExecutor(
        devices=["cpu"] * (WORLD * LOCAL)))
    return run_jobs(port, ctx)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's sharded run over 4 virtual CPU devices: the
    fused pass for both dtypes and the generic path."""
    import jax

    import libertem_tpu
    import libertem_tpu.udf  # noqa: F401  (binds libertem_tpu.udf)
    from libertem_tpu.io.dataset.memory import MemoryDataSet as JaxMemory
    from libertem_tpu.udf.base import UDFRunner as JaxRunner

    out = {}
    devices = jax.devices()[:WORLD * LOCAL]
    for kind in ("u16", "f32"):
        ds = JaxMemory(data=make_data(kind), sig_dims=2,
                       num_partitions=8).initialize()
        put(out, f"fused/{kind}", JaxRunner(
            fused_udfs(libertem_tpu)).run_for_dataset(ds, devices=devices))
    ds = JaxMemory(data=make_data("f32"), sig_dims=2,
                   num_partitions=8).initialize()
    put(out, "generic", JaxRunner([
        libertem_tpu.udf.LogsumUDF(), libertem_tpu.udf.SumUDF(),
    ]).run_for_dataset(ds, devices=devices))
    return out


def shared(results, prefix) -> list:
    """The buffer keys of ``results`` under ``prefix`` (the damage
    buffer is one a UDFResults carries, not a result list)."""
    return sorted(k for k in results
                  if k.startswith(prefix) and not k.endswith("/damage"))


def assert_ranks_equal_single(ranks, single, prefix):
    keys = shared(single, prefix)
    assert keys
    for r, res in enumerate(ranks):
        for k in keys:
            assert res[k].dtype == single[k].dtype, (r, k)
            assert np.array_equal(res[k], single[k], equal_nan=True), (r, k)


@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_fused_pass_bit_equal(ranks, single, kind):
    """Both ranks, and the one-process run over the same four workers,
    give the same bits; the pass ran fused, over the global workers'
    partitions (2 x 4)."""
    assert_ranks_equal_single(ranks, single, f"fused/{kind}/")
    for res in ranks:
        assert bool(res[f"fused_run/{kind}"])
        assert int(res[f"partitions/{kind}"]) == 2 * WORLD * LOCAL
    data = make_data(kind).astype(np.float64)
    close(ranks[1][f"fused/{kind}/0/intensity"], data.sum(axis=(0, 1)))
    close(ranks[1][f"fused/{kind}/1/intensity"], data.sum(axis=(2, 3)))


@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_fused_pass_against_jax(ranks, jax_results, kind):
    keys = shared(jax_results, f"fused/{kind}/")
    assert len(keys) >= 10
    for res in ranks:
        for k in keys:
            if kind == "u16" and k.endswith("/intensity") and (
                    "/0/" in k or "/1/" in k):
                # integer sums below 2**24: exact
                assert np.array_equal(res[k], jax_results[k]), k
            else:
                close(res[k], jax_results[k])


def test_roi_iter_partials(ranks, single):
    """The same partials on both ranks as in one process: one a
    super-step and the final one, each with its damage."""
    count = int(single["iter/count"])
    assert count >= 3
    for res in ranks:
        assert int(res["iter/count"]) == count
    assert_ranks_equal_single(ranks, single, "iter/")
    final = single[f"iter/{count - 1}/damage"]
    assert final.sum() == roi60().sum()
    first = single["iter/0/damage"]
    assert 0 < first.sum() < final.sum()


def test_param_patch(ranks, single):
    """A patch applied on both ranks after the first partial gives the
    one-process run's result; the patched masks reached the rows of the
    later super-steps only."""
    assert_ranks_equal_single(ranks, single, "patch/")
    data = make_data("f32").reshape(-1, *SIG).astype(np.float64)
    new = np.einsum("np,mp->nm", data.reshape(len(data), -1),
                    np.stack(masks(port, 11)).reshape(2, -1))
    got = ranks[0]["patch/0/intensity"].reshape(-1, 2)
    hit = np.isclose(got[:, 1], new[:, 1], rtol=1e-5)
    assert 0 < hit.sum() < len(got)


def test_generic_path(ranks, single, jax_results):
    """Logsum (no fused form) across the processes: bit for bit with
    one process, within tolerance of the JAX package."""
    for res in ranks:
        assert not bool(res["generic_run/fused"])
    assert_ranks_equal_single(ranks, single, "generic/")
    for k in shared(jax_results, "generic/"):
        close(ranks[0][k], jax_results[k])


def test_hooks_once_per_local_shard(ranks, single):
    """Each rank runs preprocess and postprocess once per local shard
    (2 each), one process once per shard (4 each); the postprocess
    doubled every row exactly once either way."""
    assert list(single["hooks_calls"]) == ["pre"] * 4 + ["post"] * 4
    for res in ranks:
        assert list(res["hooks_calls"]) == ["pre"] * 2 + ["post"] * 2
    assert_ranks_equal_single(ranks, single, "hooks/")
    data = make_data("f32").astype(np.float64)
    close(ranks[0]["hooks/0/intensity"], 2 * data.sum(axis=(2, 3)))


def test_progress_counts_global_frames(ranks):
    n = int(np.prod(NAV))
    for res in ranks:
        assert list(res["progress"]) == [n, n]


def test_numpy_udf_refused(ranks):
    for res in ranks:
        assert str(res["refused/numpy"]) == NUMPY_REFUSAL


def test_unequal_worker_counts_raise(ranks):
    for res in ranks:
        msg = str(res["refused/workers"])
        assert "same number of local workers" in msg and "[2, 1]" in msg


def test_plan_mismatch_raises(ranks):
    """A roi that differs by rank raises on both; the next run goes on
    in step."""
    for res in ranks:
        msg = str(res["refused/roi"])
        assert "run plan differs" in msg and "roi" in msg
        n = make_data("u16").astype(np.float64)
        close(res["after/0/intensity"], n.sum(axis=(0, 1)))


def test_absent_process_raises(ranks):
    """A process that left the group: the other's next collective
    raises ``UDFException`` at once instead of waiting."""
    assert "a process left the run" in str(ranks[0]["refused/absent"])
    assert "refused/absent" not in ranks[1]


def test_global_workers_and_transport(ranks):
    want = [[str(r), "cpu"] for r in range(WORLD) for _ in range(LOCAL)]
    for res in ranks:
        assert res["global_workers"].tolist() == want
        assert int(res["local_devices"]) == LOCAL
        assert str(res["transport"]) == "gloo"
        assert float(res["collective_s"]) > 0
        assert str(res["stats/transport"]) == "gloo"
        assert float(res["stats/collective_s"]) > 0


def test_write_dataset_npy(ranks, tmp_path):
    """Each rank writes the file the one-process export writes."""
    ctx = port.Context(executor=ShardedJobExecutor(
        devices=["cpu"] * (WORLD * LOCAL)))
    path = str(tmp_path / "one.npy")
    ctx.export_dataset(ctx.load("memory", data=make_data("u16"),
                                sig_dims=2), path=path)
    want = np.load(path)
    assert np.array_equal(want, make_data("u16"))
    for res in ranks:
        got = np.load(res["export"])
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_make_with_sharded(ranks):
    """``make_with("sharded")`` under the group: one local worker a
    rank, two global ones, and ``Context.load``'s partition count
    follows the global count (the 2 x 2-worker contexts above: 8)."""
    data = make_data("u16")
    for res in ranks:
        assert int(res["make_with/global"]) == WORLD
        assert int(res["make_with/partitions"]) == max(4, 2 * WORLD)
        assert np.array_equal(res["make_with/sum/0/intensity"],
                              data.sum(axis=(0, 1)).astype(np.float32))


def test_workers_import_no_jax(ranks):
    for res in ranks:
        assert not bool(res["jax_imported"])


# -- the helpers in one process ------------------------------------------


def test_one_process_helpers():
    assert distributed.world() == (0, 1)
    assert distributed.transport() is None
    cpu = torch.device("cpu")
    assert distributed.global_workers(["cpu", "cpu"]) == [
        (0, cpu), (0, cpu)]
    ts = [torch.arange(3.0), torch.arange(3.0) + 1]
    got = distributed.gather_tensors(ts, cpu)
    assert all(torch.equal(a, b) for a, b in zip(got, ts))


@pytest.mark.parametrize("dtype", [
    torch.float32, torch.float64, torch.complex64, torch.bool,
    torch.uint8, torch.int16, torch.int64])
def test_pack_unpack_roundtrip(dtype):
    """Every state dtype crosses processes as its exact bytes, each
    tensor padded to 16 bytes in the packed buffer."""
    g = torch.Generator().manual_seed(0)
    shapes = [(3,), (2, 5), (), (7, 1, 3)]
    ts = [(torch.randn(s, generator=g) * 100).to(dtype) if dtype not in (
        torch.complex64,) else torch.randn(s, generator=g,
                                           dtype=torch.complex64)
          for s in shapes]
    buf = distributed.pack(ts)
    assert buf.dtype == torch.uint8 and buf.numel() % 16 == 0
    back = distributed.unpack(buf, [(t.shape, t.dtype) for t in ts])
    for a, b in zip(ts, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_transport_follows_backend(monkeypatch):
    monkeypatch.setattr(distributed, "world", lambda: (0, 2))
    for backend, want in (("gloo", "gloo"), ("nccl", "nccl"),
                          ("cpu:gloo,cuda:nccl", "nccl")):
        monkeypatch.setattr(distributed.dist, "get_backend",
                            lambda b=backend: b)
        assert distributed.transport() == want
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: "mpi")
    with pytest.raises(UDFException, match="not supported"):
        distributed.transport()
