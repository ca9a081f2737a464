"""The port's one-copy device fetch (`utils/fetch.py`) on the CPU: the five
cases of `tests/test_fetch.py` with the same values, each against the JAX
package's `device_fetch` on the same inputs. Bit-exact: the same dtypes,
shapes and bits. The port holds uint32 words as int32 or uint32 tensors
(`.view`), so the 2^32 - 1 and 2^31 words come back exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_comments_ghr_tpu.pipeline.programs import TrackResult as JTrackResult
from orb_slam3_comments_ghr_tpu.utils.fetch import device_fetch as jfetch
from orb_slam3_comments_ghr_torch.pipeline.programs import TrackResult
from orb_slam3_comments_ghr_torch.utils.fetch import device_fetch, device_fetch_async

torch.set_num_threads(1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def test_round_trips_all_32bit_dtypes():
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.random((5, 7)).astype(np.float32),
        "i32": rng.integers(-(2**31), 2**31 - 1, (3,), dtype=np.int32),
        "u32": rng.integers(0, 2**32 - 1, (4, 8), dtype=np.uint32),
        "bool": rng.random(9) > 0.5,
    }
    out = device_fetch({k: torch.from_numpy(v) for k, v in arrays.items()})
    ref = jfetch({k: jnp.asarray(v) for k, v in arrays.items()})
    for k, v in arrays.items():
        _same(out[k], v)
        _same(out[k], ref[k])


def test_scalar_and_subword():
    a, b = device_fetch((torch.tensor(3.25, dtype=torch.float32),
                         torch.tensor([1, -2, 3], dtype=torch.int8)))
    ja, jb = jfetch((jnp.float32(3.25), jnp.asarray([1, -2, 3], jnp.int8)))
    assert a == np.float32(3.25) and a.shape == ()
    assert b.dtype == np.int8 and np.array_equal(b, [1, -2, 3])
    _same(a, ja)
    _same(b, jb)


def test_namedtuple_structure_preserved():
    r = TrackResult(R=torch.eye(3), t=torch.zeros(3), match_feat=torch.arange(4, dtype=torch.int32),
                    inlier=torch.zeros(4, dtype=torch.bool), visible=torch.ones(4, dtype=torch.bool),
                    n_inliers=torch.tensor(5, dtype=torch.int32))
    out = device_fetch(r)
    assert isinstance(out, TrackResult)
    assert int(out.n_inliers) == 5
    assert np.array_equal(out.match_feat, [0, 1, 2, 3])
    ref = jfetch(JTrackResult(R=jnp.eye(3), t=jnp.zeros(3), n_inliers=jnp.int32(5),
                              visible=jnp.ones(4, bool), inlier=jnp.zeros(4, bool),
                              match_feat=jnp.arange(4, dtype=jnp.int32)))
    for k in TrackResult._fields:
        _same(getattr(out, k), getattr(ref, k))


def test_empty_tree():
    assert device_fetch({}) == {} == jfetch({})
    fetch = device_fetch_async(((), None))
    assert fetch.ready() and fetch.get() == ((), None)


def test_extreme_uint32_exact():
    words = np.asarray([0, 1, 2**32 - 1, 2**31], np.uint32)
    out = device_fetch((torch.from_numpy(words),))[0]
    as_int32 = device_fetch((torch.from_numpy(words.view(np.int32)),))[0]
    assert np.array_equal(out, words)
    assert np.array_equal(as_int32.view(np.uint32), words)
    _same(out, jfetch((jnp.asarray(words),))[0])
