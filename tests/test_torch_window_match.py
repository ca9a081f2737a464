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
from orb_slam3_comments_ghr_torch.utils import match_cases

torch.set_num_threads(1)

BIG = 1 << 20


def _test_order(arrays):
    """window_match's argument order -> this file's (uint32 words)."""
    qd, quv, qrad, qlo, qhi, td, txy, tlvl, tval = arrays
    return qd.view(np.uint32), td.view(np.uint32), quv, txy, qrad, qlo, qhi, tlvl, tval


def _problem(seed=0, N=256, M=512, radius=80.0):
    """The recipe of tests/test_pallas_match.py, as numpy arrays."""
    return _test_order(match_cases.random_problem(seed, N, M, radius))


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

    # the Pallas kernel takes N % 128 == 0: pad with rows of radius -1
    n = p[0].shape[0]
    pad = -n % pallas_match.TILE_N
    qd, quv, qrad, qlo, qhi = (np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
                               for a, fill in zip((p[0], p[2], p[4], p[5], p[6]), (0, 0, -1, 0, 0)))
    td, txy, tlvl, tval = p[1], p[3], p[7], p[8]
    out = pallas_match.window_match_tpu(
        jmatching.unpack_pm1(jnp.asarray(qd)), jnp.asarray(quv), jnp.asarray(qrad),
        jnp.asarray(qlo), jnp.asarray(qhi), jmatching.unpack_pm1(jnp.asarray(td)),
        jnp.asarray(txy), jnp.asarray(tlvl), jnp.asarray(tval), interpret=True,
    )
    return tuple(np.asarray(x)[:n] for x in out)


def _numpy_ref(p):
    """The function by its definition, in numpy float32: for the inputs
    JAX's paths are not held to (non-finite coordinates, no target)."""
    qd, td, quv, txy, qrad, qlo, qhi, tlvl, tval = p
    n, m = qd.shape[0], td.shape[0]
    if m == 0:
        return np.zeros(n, np.int32), np.full(n, BIG, np.int32), np.full(n, BIG, np.int32)
    with np.errstate(invalid="ignore"):
        mask = ((np.abs(quv[:, None, 0] - txy[None, :, 0]) < qrad[:, None])
                & (np.abs(quv[:, None, 1] - txy[None, :, 1]) < qrad[:, None])
                & (tval[None, :] > 0) & (tlvl[None, :] >= qlo[:, None])
                & (tlvl[None, :] <= qhi[:, None]))
    dist = np.unpackbits((qd[:, None, :] ^ td[None, :, :]).view(np.uint8), axis=-1).sum(-1)
    d = np.where(mask, dist, BIG).astype(np.int32)
    idx = np.argmin(d, axis=1)
    best = d[np.arange(n), idx]
    d[np.arange(n), idx] = BIG
    return idx.astype(np.int32), best, d.min(axis=1)


def _assert_same(ours, ref, qd, td):
    idx, best, second = ours
    idx_r, best_r, second_r = ref
    np.testing.assert_array_equal(best, best_r)
    np.testing.assert_array_equal(second, second_r)
    hit = best_r < (1 << 20)
    dist = tmatching.hamming_matrix(torch.from_numpy(qd.view(np.int32)),
                                    torch.from_numpy(td.view(np.int32))).numpy()
    took = dist[np.flatnonzero(hit), idx[hit]]
    np.testing.assert_array_equal(took, best_r[hit])
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
    before = wm.launches
    ours = wm.window_match(*args)
    plain = wm.window_match_plain(*args)
    assert wm.launches == before
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
        before = wm.launches
        idx, best, second = (x.cpu().numpy() for x in wm.window_match(*args))
        torch.cuda.synchronize()
        assert wm.launches == before + 1
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
    before = wm.launches
    ours = tuple(x.cpu().numpy() for x in wm.window_match(*args))
    torch.cuda.synchronize()
    assert wm.launches == before + 1
    plain = tuple(x.cpu().numpy() for x in wm.window_match_plain(*args))
    _assert_same(ours, plain, p[0], p[1])



def _edge_problem(case):
    return _test_order(match_cases.edge_problem(case))


EDGE_CASES, PLAIN_ONLY = list(match_cases.EDGE_CASES), list(match_cases.PLAIN_ONLY)


@pytest.mark.parametrize("ref", sorted(REFERENCES))
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_cases_match_jax(case, ref):
    p = _edge_problem(case)
    ours = _port(p)
    _assert_same(ours, REFERENCES[ref](p), p[0], p[1])
    if case == "on_edge":  # the exact-r targets would change these rows
        assert (ours[1] < BIG).any()


@pytest.mark.parametrize("case", PLAIN_ONLY)
def test_edge_cases_match_definition(case):
    p = _edge_problem(case)
    ours = _port(p)
    _assert_same(ours, _numpy_ref(p), p[0], p[1])
    if case != "no_targets":
        assert (ours[1] < BIG).any()


def _card_args(p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _port_args(p, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(match_cases.ALL_CASES))
def test_kernel_matches_plain_on_edge_cases(case):
    p = _edge_problem(case)
    args = _card_args(p)
    before = wm.launches
    ours = tuple(x.cpu().numpy() for x in wm.window_match(*args))
    assert wm.launches == before + 1
    plain = tuple(x.cpu().numpy() for x in wm.window_match_plain(*args))
    _assert_same(ours, plain, p[0], p[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "huge_r", "chunks"])
def test_kernel_is_deterministic(case):
    args = _card_args(_edge_problem(case))
    first = torch.stack(wm.window_match(*args))
    second = torch.stack(wm.window_match(*args))
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_takes_misaligned_views():
    # descriptors and pixels as views 4 bytes into their buffers: the kernel
    # stages such descriptors by 4-byte copies instead of 16-byte ones
    p = _problem(13, N=300, M=500, radius=40.0)
    args = list(_card_args(p))
    for i in (5, 6):
        buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device="cuda")
        buf[1:] = args[i].flatten()
        args[i] = buf[1:].view(args[i].shape)
        assert args[i].data_ptr() % 16 != 0
    ours = tuple(x.cpu().numpy() for x in wm.window_match(*args))
    plain = tuple(x.cpu().numpy() for x in wm.window_match_plain(*args))
    _assert_same(ours, plain, p[0], p[1])


@pytest.mark.gpu
def test_graph_replay_equals_eager():
    args = _card_args(_caller_problem(14, "fuse", 4096, 1024))
    eager = torch.stack(wm.window_match(*args))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = wm.window_match(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(captured), eager)
