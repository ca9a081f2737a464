"""The PyTorch port's window match against the JAX package: the Pallas
kernel in interpret mode and the XLA path (window_mask + hamming_matrix +
masked_best2). `best` and `second` must be bit-equal; `idx` equal, or where
it differs, at a column whose distance equals `best` (a tie).

The JAX package is imported inside the reference helpers, not at the top:
the `gpu` test must also collect on a CUDA machine without JAX (run there
as `python -m pytest --noconftest -m gpu` on this file)."""

import numpy as np
import pytest
import torch

from orb_slam3_comments_ghr_torch.ops import matching as tmatching
from orb_slam3_comments_ghr_torch.ops import window_match as wm

torch.set_num_threads(1)


def _problem(seed=0, N=256, M=512, radius=80.0):
    """The recipe of tests/test_pallas_match.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    qd = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    td = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    quv = rng.random((N, 2), np.float32) * 600
    txy = rng.random((M, 2), np.float32) * 600
    qrad = np.full((N,), radius, np.float32)
    qlo = rng.integers(0, 3, N).astype(np.float32)
    qhi = qlo + 2
    tlvl = rng.integers(0, 8, M).astype(np.float32)
    tval = (rng.random(M) > 0.1).astype(np.float32)
    return qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval


def _port_args(p, device="cpu"):
    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = p
    args = (qd.view(np.int32), quv, qrad, qlo, qhi, td.view(np.int32), txy, tlvl, tval)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args)


def _port(p):
    return tuple(x.numpy() for x in wm.window_match(*_port_args(p)))


def _xla(p):
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import matching as jmatching

    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = (jnp.asarray(a) for a in p)
    mask = jmatching.window_mask(
        quv, jnp.zeros(qd.shape[0], jnp.int32), txy, tlvl.astype(jnp.int32),
        tval.astype(bool), qrad,
        level_lo=qlo.astype(jnp.int32), level_hi=qhi.astype(jnp.int32),
    )
    return tuple(np.asarray(x) for x in
                 jmatching.masked_best2(jmatching.hamming_matrix(qd, td), mask))


def _pallas(p):
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import matching as jmatching, pallas_match

    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = (jnp.asarray(a) for a in p)
    out = pallas_match.window_match_tpu(
        jmatching.unpack_pm1(qd), quv, qrad, qlo, qhi, jmatching.unpack_pm1(td),
        txy, tlvl, tval, interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


def _assert_same(ours, ref, qd, td):
    idx, best, second = ours
    idx_r, best_r, second_r = ref
    np.testing.assert_array_equal(best, best_r)
    np.testing.assert_array_equal(second, second_r)
    hit = best_r < (1 << 20)
    dist = tmatching.hamming_matrix(torch.from_numpy(qd.view(np.int32)),
                                    torch.from_numpy(td.view(np.int32))).numpy()
    took = dist[np.arange(len(idx)), idx]
    np.testing.assert_array_equal(took[hit], best_r[hit])
    np.testing.assert_array_equal(idx[~hit], 0)
    np.testing.assert_array_equal(idx_r[~hit], 0)


REFERENCES = {"pallas": _pallas, "xla": _xla}


@pytest.mark.parametrize("ref", sorted(REFERENCES))
@pytest.mark.parametrize("seed,radius", [(0, 80.0), (1, 15.0), (2, 300.0)])
def test_matches_jax(seed, radius, ref):
    p = _problem(seed, radius=radius)
    _assert_same(_port(p), REFERENCES[ref](p), p[0], p[1])


def test_ragged_rows_match_xla():
    # the Pallas kernel wants N % 128 == 0; the port takes any N and M
    p = _problem(5, N=200, M=333, radius=60.0)
    _assert_same(_port(p), _xla(p), p[0], p[1])


def test_radius_zero_rows_are_empty():
    p = _problem(3)
    p = p[:4] + (np.zeros_like(p[4]),) + p[5:]
    idx, best, second = _port(p)
    assert (best == (1 << 20)).all() and (second == (1 << 20)).all()
    assert (idx == 0).all()
    _assert_same((idx, best, second), _pallas(p), p[0], p[1])


def test_negative_radius_hides_row():
    # the tracking path marks invisible points with radius -1
    p = _problem(6)
    rad = p[4].copy()
    rad[::3] = -1.0
    idx, best, second = _port(p[:4] + (rad,) + p[5:])
    assert (best[::3] == (1 << 20)).all() and (idx[::3] == 0).all()
    assert (best[1::3] < (1 << 20)).any()


def test_hamming_matrix_matches_jax():
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import matching as jmatching

    qd, td = _problem(9, N=100, M=130)[:2]
    np.testing.assert_array_equal(
        tmatching.hamming_matrix(torch.from_numpy(qd.view(np.int32)),
                                 torch.from_numpy(td.view(np.int32))).numpy(),
        np.asarray(jmatching.hamming_matrix(jnp.asarray(qd), jnp.asarray(td))))


@pytest.mark.parametrize("th,ratio", [(50, 0.9), (100, 0.8)])
def test_search_by_window_matches_jax(th, ratio):
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import matching as jmatching

    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = _problem(10, N=150, M=220, radius=90.0)
    T = torch.from_numpy
    mask = tmatching.window_mask(T(quv), T(txy), T(tlvl), T(tval > 0), T(qrad), T(qlo), T(qhi))
    ours = tmatching.search_by_window(T(qd.view(np.int32)), T(td.view(np.int32)), mask, th, ratio)
    jmask = jnp.asarray(mask.numpy())
    ref = jmatching.search_by_window(jnp.asarray(qd), jnp.asarray(td), jmask, th, ratio, use_mxu=False)
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ours[0].numpy()[ours[2].numpy()], np.asarray(ref[0])[ours[2].numpy()])


def test_popcount32_edge_words():
    words = np.array([0, 1, -1, -(2**31), 2**31 - 1, 0x55555555, -0x55555556], np.int32)
    expect = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words]
    got = tmatching.popcount32(torch.from_numpy(words))
    assert got.dtype == torch.int32
    assert got.tolist() == expect


def test_cpu_takes_plain_version_without_launch():
    args = _port_args(_problem(7, N=64, M=96))
    before = wm.window_match.launches
    ours = wm.window_match(*args)
    plain = wm.window_match_plain(*args)
    assert wm.window_match.launches == before
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    args = list(_port_args(_problem(8, N=32, M=48)))
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[6] = args[6][:-1]
    else:
        args[5] = args[5].t().contiguous().t()
    with pytest.raises(ValueError):
        wm.window_match(*args)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed, n, m, radius in [(0, 4096, 1024, 80.0), (1, 1000, 777, 15.0), (2, 1000, 777, 0.0)]:
        p = _problem(seed, N=n, M=m, radius=radius)
        args = _port_args(p, "cuda")
        before = wm.window_match.launches
        idx, best, second = (x.cpu().numpy() for x in wm.window_match(*args))
        torch.cuda.synchronize()
        assert wm.window_match.launches == before + 1
        plain = tuple(x.cpu().numpy() for x in wm.window_match_plain(*args))
        _assert_same((idx, best, second), plain, p[0], p[1])


def _caller_problem(seed, caller, N, M):
    """Inputs as two-view init (radius 100 on level-0 rows, -1 elsewhere;
    band -1..8; half the targets invalid) and fuse (radius 3 * 1.2^level,
    band level +- 1, a quarter of the points invisible) call the kernel."""
    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = _problem(seed, N=N, M=M)
    rng = np.random.default_rng(seed + 100)
    if caller == "init":
        qrad = np.where(rng.random(N) < 0.7, np.float32(100.0), np.float32(-1.0)).astype(np.float32)
        qlo, qhi = np.full(N, -1.0, np.float32), np.full(N, 8.0, np.float32)
        tval = (rng.random(M) > 0.5).astype(np.float32)
    else:
        lvl = rng.integers(0, 8, N).astype(np.float32)
        qrad = np.where(rng.random(N) > 0.25, np.float32(3.0) * np.float32(1.2) ** lvl,
                        np.float32(-1.0)).astype(np.float32)
        qlo, qhi = lvl - 1, lvl + 1
    return qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval


@pytest.mark.parametrize("caller", ["init", "fuse"])
def test_caller_shapes_match_xla(caller):
    p = _caller_problem(11, caller, 256, 300)
    _assert_same(_port(p), _xla(p), p[0], p[1])


@pytest.mark.gpu
@pytest.mark.parametrize("caller,n,m", [("init", 1024, 1024), ("fuse", 4096, 1024)])
def test_kernel_matches_plain_at_caller_shapes(caller, n, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _caller_problem(12, caller, n, m)
    args = _port_args(p, "cuda")
    before = wm.window_match.launches
    ours = tuple(x.cpu().numpy() for x in wm.window_match(*args))
    torch.cuda.synchronize()
    assert wm.window_match.launches == before + 1
    plain = tuple(x.cpu().numpy() for x in wm.window_match_plain(*args))
    _assert_same(ours, plain, p[0], p[1])
