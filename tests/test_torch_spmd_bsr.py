"""K6 and the sharded BSR planning of the port against the JAX package, on
the CPU, in one process: the host format's sharding arguments
(``ell_to_strip_window(ncols=, force_width=)``), the per-shard window
plans, and K6's plain version against the JAX edge-buffer kernel run in
interpret mode.

Host arrays must be byte-identical.  K6's plain version is held against
the JAX kernel within 1e-5 of max|ref| in f32 (the JAX package's own
tolerance for the window kernels, tests/test_spmd_bsr.py), and against
K5's plain version on the concatenated frame bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lobpcg_tpu.operators.sparse import BSROperator as JBSROperator
from lobpcg_tpu.ops.pallas import bsr as jbsr
from lobpcg_tpu.parallel import row_mesh as jrow_mesh
from lobpcg_tpu.parallel import spmd_bsr as jspmd
import lobpcg_tpu_torch as tl
from lobpcg_tpu_torch.ops.cuda import bsr as kb
from lobpcg_tpu_torch.parallel import RowMesh, ShardedBSROperator, plan_shards
from lobpcg_tpu_torch.parallel import spmd_bsr as tspmd

torch.set_num_threads(2)


def _banded_matrix(n, bw, seed=0):
    """tests/test_spmd_bsr.py:_banded_matrix."""
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n))
    for d in range(-bw, bw + 1):
        A += np.diag(rng.randn(n - abs(d)) * (0.3 ** abs(d)), d)
    return 0.5 * (A + A.T) + 2 * bw * np.eye(n)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _mesh(rank, size):
    """A mesh for planning only: no process group behind it."""
    return RowMesh(group=None, rank=rank, size=size, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def interior_shard():
    """tests/test_spmd_bsr.py:146-203's inputs: the middle third of a
    3x-taller band as one interior shard, its extended-frame window plan
    and random X and halos."""
    n, bw, k, bs = 2048, 17, 128, 8
    A = _banded_matrix(3 * n, bw).astype(np.float32)
    op = JBSROperator.from_dense(A, block_size=bs, dtype=jnp.float32)
    nb = n // bs
    sl = slice(nb, 2 * nb)
    cols_all, blocks_all = np.asarray(op.block_cols), np.asarray(op.blocks)
    H = jspmd._ell_halo_width(cols_all, blocks_all)
    cols = jspmd._safe_cols(cols_all, blocks_all)[sl] - (nb - H)
    lo, wv = jbsr.ell_to_strip_window(cols, blocks_all[sl], ncols=nb + 2 * H)
    rng = np.random.RandomState(11)
    xs = rng.randn(n, k).astype(np.float32)
    halo_up = rng.randn(H * bs, k).astype(np.float32)
    halo_dn = rng.randn(H * bs, k).astype(np.float32)
    W = wv.shape[2]
    return {"n": n, "bs": bs, "hrows": H * bs, "lo": lo, "wv": wv, "xs": xs,
            "halo_up": halo_up, "halo_dn": halo_dn, "W": W,
            "edge_top": np.concatenate([halo_up, xs[:W]]),
            "edge_bot": np.concatenate([xs[-W:], halo_dn]),
            "cols": cols, "blocks": blocks_all[sl], "ncols": nb + 2 * H}


def test_k6_plain_version_matches_the_jax_kernel(interior_shard):
    s = interior_shard
    n, bs, hrows, W = s["n"], s["bs"], s["hrows"], s["W"]
    starts = s["lo"] * bs
    # All three source classes occur, or the test means little.
    assert (starts < hrows).any()
    assert (starts > hrows + n - W).any()
    assert ((starts >= hrows) & (starts <= hrows + n - W)).any()

    y_jax = np.asarray(jbsr.bsr_window_matmat_pallas_edges(
        jnp.asarray(s["lo"], jnp.int32), jnp.asarray(s["wv"]),
        jnp.asarray(s["xs"]), jnp.asarray(s["edge_top"]),
        jnp.asarray(s["edge_bot"]), bs=bs, hrows=hrows, interpret=True,
        out_rows=n))
    t = {key: torch.from_numpy(s[key])
         for key in ("lo", "wv", "xs", "edge_top", "edge_bot")}
    y_port = kb.bsr_window_matmat_edges(
        t["lo"], t["wv"], t["xs"], t["edge_top"], t["edge_bot"], bs=bs,
        hrows=hrows, out_rows=n)
    assert tuple(y_port.shape) == (n, s["xs"].shape[1])
    err = np.abs(y_port.numpy() - y_jax).max() / np.abs(y_jax).max()
    assert err < 1e-5, err

    x_ext = torch.from_numpy(np.concatenate([s["halo_up"], s["xs"],
                                             s["halo_dn"]]))
    y_k5 = kb.bsr_window_matmat_reference(t["lo"], t["wv"], x_ext, bs=bs,
                                          out_rows=n)
    assert torch.equal(y_port, y_k5)


@pytest.mark.parametrize("force", [None, 48, 64])
def test_strip_window_sharding_arguments_match_jax(interior_shard, force):
    """ncols = nb + 2H (the extended frame) with and without a forced
    width: both packages' (lo, win_vals) byte-identical."""
    s = interior_shard
    kw = {"ncols": s["ncols"], "force_width": force}
    for strip in (128, 256):
        got = kb.ell_to_strip_window(s["cols"], s["blocks"], strip=strip, **kw)
        want = jbsr.ell_to_strip_window(s["cols"], s["blocks"], strip=strip, **kw)
        for a, b in zip(got, want):
            _same(a, b)
    with pytest.raises(ValueError, match="force_width"):
        kb.ell_to_strip_window(s["cols"], s["blocks"], ncols=s["ncols"],
                               force_width=1)


@pytest.mark.parametrize("nd,n", [(2, 2048), (4, 2048), (8, 2048), (4, 256)])
def test_shard_plans_match_jax(nd, n):
    """The port's per-shard planning gives every shard the JAX
    ShardedBSROperator's halo, window starts and window values."""
    A = _banded_matrix(n, 17)
    jop = JBSROperator.from_dense(A, block_size=8, dtype=jnp.float32)
    jsop = jspmd.ShardedBSROperator.shard(jop, jrow_mesh(nd))
    top = tl.BSROperator.from_dense(A, block_size=8, dtype=torch.float32,
                                    device="cpu")
    plan = plan_shards(top, nd)
    assert plan.halo == jsop.halo
    assert (plan.width is None) == (jsop.win_lo is None)
    for d in range(nd):
        sop = ShardedBSROperator.shard(top, _mesh(d, nd))
        if plan.width is not None:
            _same(plan.lo[d], np.asarray(jsop.win_lo)[d])
            _same(plan.win[d], np.asarray(jsop.win_vals)[d])
            _same(sop.win_vals.numpy(), plan.win[d])
        else:
            assert sop.win_vals is None


def test_halo_and_safe_columns_match_jax():
    for bw in (1, 5, 17):
        jop = JBSROperator.from_dense(_banded_matrix(256, bw), block_size=8,
                                      dtype=jnp.float64)
        cols, blocks = np.asarray(jop.block_cols), np.asarray(jop.blocks)
        assert tspmd._ell_halo_width(cols, blocks) == \
            jspmd._ell_halo_width(cols, blocks)
        _same(tspmd._safe_cols(cols, blocks), jspmd._safe_cols(cols, blocks))
