"""A pool of spawned gloo ranks for the distributed tier's parity tests.

The port runs one process per shard, so its tests need real processes.
`Pool` starts WORLD=4 of them once per test file (the `pool` fixture),
joined by one gloo process group, with one subgroup per world size D in
SIZES = (1, 2, 4) over ranks [0, D). `Pool.run(D, task, ...)` runs a
task of this module on ranks 0..D-1 of the D-rank subgroup and returns
each rank's result, rank order. A task gets the rank's `Mesh` first.

This module imports torch and the port only: the pool's processes never
load jax. Inputs and results cross the process boundary pickled, as
numpy arrays (and the port's HostBatch).
"""
import datetime
import multiprocessing
import queue
import traceback

import numpy as np
import pytest

WORLD = 4
SIZES = (1, 2, 4)
TIMEOUT_S = 300


def _to_host(x):
    """Tensors in a (nested) result -> numpy; tuples stay tuples."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return tuple(_to_host(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# tasks (run inside a rank; the first argument is the rank's Mesh)
# ---------------------------------------------------------------------------

def builder(mesh, module: str, name: str, kwargs: dict, inputs):
    """Build `arrow_go_tpu_torch.parallel.<module>.<name>(mesh,
    **kwargs)` and call it on this rank's row block of each global
    input array. Returns the rank's outputs as numpy."""
    import importlib
    from arrow_go_tpu_torch.parallel.mesh import row_sharding
    mod = importlib.import_module(f"arrow_go_tpu_torch.parallel.{module}")
    fn = getattr(mod, name)(mesh, **kwargs)
    sh = row_sharding(mesh)
    return _to_host(fn(*[sh.put(a) for a in inputs]))


def api(mesh, name: str, args, kwargs: dict):
    """`arrow_go_tpu_torch.parallel.api.<name>(*args, mesh=mesh,
    **kwargs)`: HostBatches in, a HostBatch out (every rank's is the
    whole result)."""
    from arrow_go_tpu_torch.parallel import api as papi
    return getattr(papi, name)(*args, mesh=mesh, **kwargs)


def mesh_info(mesh, n_rows: int):
    """(rank, world size, local_row_range, this rank's block of
    arange(8*D) through row_sharding, all of it through replicated)."""
    from arrow_go_tpu_torch.parallel import mesh as pm
    data = np.arange(8 * mesh.world_size)
    return (mesh.rank, mesh.world_size,
            tuple(pm.local_row_range(mesh, n_rows)),
            _to_host(pm.row_sharding(mesh).put(data)),
            _to_host(pm.replicated(mesh).put(data)))


def global_mesh_info(mesh):
    """(rank, world size, device type, whether its group is the default
    one) of global_mesh() on the CPU, beside this rank's mesh."""
    from arrow_go_tpu_torch.parallel import global_mesh
    g = global_mesh(device="cpu")
    return (g.rank, g.world_size, g.device.type, g.group is None,
            mesh.rank, mesh.world_size)


def bench_overlap(mesh, **kwargs):
    from arrow_go_tpu_torch.parallel import overlap
    return overlap.bench_overlap(mesh, **kwargs)


TASKS = {f.__name__: f for f in (builder, api, mesh_info, global_mesh_info,
                                  bench_overlap)}


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _serve(rank: int, port: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist
    from arrow_go_tpu_torch.parallel.mesh import Mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    groups = {D: dist.new_group(list(range(D))) for D in SIZES}
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            D, name, args, kwargs = task
            g = groups[D]
            mesh = Mesh(g, dist.get_rank(g), D, torch.device("cpu"))
            try:
                results.put((rank, True, TASKS[name](mesh, *args, **kwargs)))
            except Exception:     # reported to the test, which raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """WORLD spawned gloo ranks serving tasks until close()."""

    def __init__(self):
        from arrow_go_tpu_torch.parallel.mesh import free_port
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(WORLD)]
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, port, self.tasks[r], self.results)) for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, D: int, task: str, *args, **kwargs) -> list:
        """Run `task` on ranks [0, D) of the D-rank group; each rank's
        result in rank order. Raises with the traceback of a rank that
        failed."""
        for r in range(D):
            self.tasks[r].put((D, task, args, kwargs))
        out, errors = [None] * D, []
        for _ in range(D):
            try:
                rank, ok, val = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError(f"{task}: no result within {TIMEOUT_S} s")
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError(f"{task} failed on D={D}:\n" +
                               "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def pool():
    p = Pool()
    try:
        yield p
    finally:
        p.close()


# ---------------------------------------------------------------------------
# comparing a rank's outputs with the JAX output's blocks
# ---------------------------------------------------------------------------

def flat(x) -> list:
    """Leaves of a nested result, depth first."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in flat(v)]
    return [np.asarray(x)]


def same(got, want, what: str) -> None:
    """Ints, bools and keys bit for bit; floats at rtol 1e-9."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_blocks(jax_out, rank_outs, spans=()) -> None:
    """Each rank's outputs against its block of the JAX outputs. spans:
    (first leaf, stop leaf, count leaf): those leaves compare over the
    rank's [0, count) prefix only; every other leaf (counts, flags,
    whole-block results) compares in full. A 0-d JAX leaf (replicated)
    equals every rank's."""
    jl = flat(jax_out)
    D = len(rank_outs)
    prefix = {}
    for a, b, c in spans:
        for i in range(a, b):
            prefix[i] = c
    for d, out in enumerate(rank_outs):
        rl = flat(out)
        assert len(rl) == len(jl), (len(rl), len(jl))
        for i, (j, r) in enumerate(zip(jl, rl)):
            blk = j if j.ndim == 0 else j.reshape(D, -1)[d]
            if i in prefix:
                n = int(np.asarray(rl[prefix[i]]).reshape(-1)[0])
                assert n == int(jl[prefix[i]].reshape(D, -1)[d][0]), \
                    (d, i, n)
                same(r[:n], blk[:n], f"rank {d} leaf {i}")
            else:
                same(r, blk, f"rank {d} leaf {i}")
