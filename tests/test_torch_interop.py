"""The port imports no JAX, and its carry-across functions
(lobpcg_tpu_torch/interop.py) round-trip the JAX package's operators and
config."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lobpcg_tpu as jl
from lobpcg_tpu.operators.sparse import BSROperator as JBSROperator
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.interop import config_from_reference, operator_from_reference
from lobpcg_tpu_torch.parallel import ShardedBSROperator, SpmdLaplacian1D
from test_torch_spmd_bsr import _banded_matrix, _mesh, _same

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import lobpcg_tpu_torch, lobpcg_tpu_torch.interop\n"
        "import lobpcg_tpu_torch.ops.cuda.stencil\n"
        "import lobpcg_tpu_torch.ops.cuda.stencil3d\n"
        "import lobpcg_tpu_torch.ops.cuda.bsr\n"
        "import lobpcg_tpu_torch.operators.stencil_nd\n"
        "import lobpcg_tpu_torch.operators.sparse\n"
        "import lobpcg_tpu_torch.utils.native\n"
        "import lobpcg_tpu_torch.ops.cuda.copy\n"
        "import lobpcg_tpu_torch.physics, lobpcg_tpu_torch.physics.bdg\n"
        "import lobpcg_tpu_torch.operators.realify\n"
        "import lobpcg_tpu_torch.utils.checkpoint\n"
        "import lobpcg_tpu_torch.utils.plan\n"
        "import lobpcg_tpu_torch.utils.profiling\n"
        "import lobpcg_tpu_torch.benchmarks.solve_bdg\n"
        "import lobpcg_tpu_torch.bench\n"
        "import lobpcg_tpu_torch.tools.plan_anchors\n"
        "import lobpcg_tpu_torch.tools.convergence_trace\n"
        "import lobpcg_tpu_torch.tools.stencil_widths\n"
        "import lobpcg_tpu_torch.ops.rows\n"
        "import lobpcg_tpu_torch.solvers.batched\n"
        "import lobpcg_tpu_torch.parallel, lobpcg_tpu_torch.parallel.mesh\n"
        "import lobpcg_tpu_torch.parallel.sharding\n"
        "import lobpcg_tpu_torch.parallel.spmd_stencil\n"
        "import lobpcg_tpu_torch.parallel.spmd_bsr\n"
        "import lobpcg_tpu_torch.graft_entry\n"
        "import lobpcg_tpu_torch.examples\n"
        "import lobpcg_tpu_torch.examples.laplacian_1d\n"
        "import lobpcg_tpu_torch.examples.bdg_indefinite\n"
        "import lobpcg_tpu_torch.examples.checkpoint_resume\n"
        "import lobpcg_tpu_torch.examples.sparse_3d_laplacian\n"
        "import lobpcg_tpu_torch.examples.complex_on_gpu\n"
        "import lobpcg_tpu_torch.examples.fft_matrix_free\n"
        "import lobpcg_tpu_torch.examples.sharded_solve\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'lobpcg_tpu'"
        " or m.startswith('lobpcg_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _tree(dtype):
    n, m = 16, 8
    d = np.linspace(1.0, 2.0, n).astype(dtype)
    lap = jl.Laplacian1D(scale=jnp.asarray(dtype(2.0)), n=n, segments=2)
    A = lap + jl.DiagonalOperator(jnp.asarray(d))
    return {
        "sum": A,
        "jacobi": jl.JacobiPreconditioner(jnp.asarray(d)),
        "antidiag": jl.BlockAntiDiagOperator(d=jnp.asarray(d[:m])),
        "blockdiag": jl.BlockDiagOperator(
            inner=jl.Laplacian1D(scale=jnp.asarray(dtype(1.0)), n=m)),
        "scaled": 3.0 * lap,
        "shifted": jl.ShiftedOperator(lap, jnp.asarray(dtype(0.5))),
        "composed": jl.ComposedOperator(lap, lap),
        "dense": jl.DenseOperator(jnp.asarray(np.eye(n, dtype=dtype))),
        "laplacian_nd": jl.LaplacianND(scale=jnp.asarray(dtype(2.0)),
                                       grid=(2, 2, 4)),
        "laplacian_nd_2d": jl.LaplacianND(scale=jnp.asarray(dtype(2.0)),
                                          grid=(4, 4)),
        "bsr": JBSROperator.from_dense(
            np.diag(d) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1),
            block_size=8, dtype=dtype),
        "cheb": jl.ChebyshevFilter(op=A, lo=jnp.asarray(dtype(1.0)),
                                   hi=jnp.asarray(dtype(10.0)), degree=3,
                                   chunk=2),
    }


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(_tree(np.float64)))
def test_operator_from_reference_round_trip(name, dtype):
    jop = _tree(dtype)[name]
    top = operator_from_reference(jop, device="cpu")
    assert type(top).__name__ == type(jop).__name__
    assert tuple(top.shape) == tuple(jop.shape)
    assert top.dtype == getattr(torch, np.dtype(dtype).name)
    X = np.random.default_rng(0).uniform(-1, 1, (16, 4)).astype(dtype)
    np.testing.assert_allclose(
        top.matmat(torch.from_numpy(X)).numpy(),
        np.asarray(jop.matmat(jnp.asarray(X))),
        rtol=1e-5 if dtype == np.float32 else 1e-12, atol=1e-5,
    )


def test_operator_from_reference_casts_dtype():
    top = operator_from_reference(_tree(np.float64)["sum"], device="cpu",
                                  dtype=torch.float32)
    assert top.dtype == torch.float32
    assert top.left.dtype == torch.float32
    assert top.right.d.dtype == torch.float32


def test_operator_from_reference_rejects_unknown():
    with pytest.raises(TypeError):
        operator_from_reference(object(), device="cpu")


def test_config_from_reference_round_trip():
    cfg = jl.SolverConfig(nev=3, size_sub=7, tol=1e-7, max_iter=42,
                          rr_method="auto", stall_reset=3, rr_dtype="float64",
                          record_history=True)
    t = config_from_reference(cfg)
    assert isinstance(t, tl.SolverConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(cfg)
    assert t.resolved_rr_dtype(torch.float32) == torch.float64


def test_operator_from_reference_converts_the_sharded_operators():
    """Given the port's mesh, a JAX ShardedBSROperator keeps its planning
    (this rank's window starts and values, byte-identical to the port's
    own plan) and a JAX SpmdLaplacian1D becomes the port's."""
    from lobpcg_tpu.parallel import SpmdLaplacian1D as JSpmdLaplacian1D
    from lobpcg_tpu.parallel import ShardedBSROperator as JShardedBSROperator
    from lobpcg_tpu.parallel import row_mesh as jrow_mesh

    nd, n = 4, 2048
    A = _banded_matrix(n, 17)
    jmesh = jrow_mesh(nd)
    jsop = JShardedBSROperator.shard(
        JBSROperator.from_dense(A, block_size=8, dtype=jnp.float32), jmesh)
    top = tl.BSROperator.from_dense(A, block_size=8, dtype=torch.float32,
                                    device="cpu")
    for r in range(nd):
        mesh = _mesh(r, nd)
        got = operator_from_reference(jsop, device="cpu", mesh=mesh)
        mine = ShardedBSROperator.shard(top, mesh)
        assert isinstance(got, ShardedBSROperator) and got.mesh is mesh
        assert (got.halo, got.bs, got.n) == (mine.halo, mine.bs, mine.n)
        for a, b in ((got.win_lo, mine.win_lo), (got.win_vals, mine.win_vals),
                     (got.block_cols, mine.block_cols),
                     (got.blocks, mine.blocks)):
            _same(a.numpy(), b.numpy())
    jlap = JSpmdLaplacian1D(scale=jnp.asarray(2.0), n=64, segments=2,
                            mesh=jmesh)
    got = operator_from_reference(jlap, device="cpu", mesh=_mesh(1, nd))
    assert isinstance(got, SpmdLaplacian1D)
    assert (got.scale, got.n, got.segments, got.dtype) == (
        2.0, 64, 2, torch.float64)
    with pytest.raises(ValueError, match="mesh"):
        operator_from_reference(jlap, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        operator_from_reference(jlap, device="cpu", mesh=_mesh(0, 2))
