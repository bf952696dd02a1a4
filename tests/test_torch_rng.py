"""The port's RNG engines against the JAX package, bit for bit: Lehmer
states and uniforms, minstd_rand0 seeding, threefry fold_in, the murmur3
fast uniforms and the R2 jitter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops import rng as jrng
from opencl_path_tracer_tpu_torch.ops import rng

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def test_lehmer_states_and_uniforms_bit_equal():
    rs = np.random.default_rng(0)
    s = rs.integers(1, 2**31 - 1, 5000, dtype=np.int64)
    js, ps = jnp.asarray(s.astype(np.uint32)), torch.from_numpy(s)
    for _ in range(6):
        js, ju = jrng.lehmer_step(js)
        ps, pu = rng.lehmer_step(ps)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pu.numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))


def test_modmul31_edges():
    a = torch.tensor([0, 1, 2**31 - 2, 2**30, 48271], dtype=torch.int64)
    got = rng.modmul31(a, 2**31 - 2).numpy()
    want = [(int(x) * (2**31 - 2)) % (2**31 - 1) for x in a]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jrng.modmul31(jnp.asarray(a.numpy(), jnp.uint32),
                                      np.uint32(2**31 - 2))))


@pytest.mark.parametrize("n,seed", [(1, 1), (4097, 1), (10000, 12345)])
def test_minstd_seeding_matches_sequential(n, seed):
    np.testing.assert_array_equal(rng.minstd_rand0_raw(n, seed),
                                  jrng.minstd_rand0_raw(n, seed))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
@pytest.mark.parametrize("data", [0, 1, 255, 2**20 + 3, 2**32 - 1])
def test_threefry_fold_in_bit_equal(seed, data):
    key = jax.random.key(seed)
    assert rng.key(seed) == tuple(int(x) for x in jax.random.key_data(key))
    want = jax.random.key_data(jax.random.fold_in(key, np.uint32(data)))
    assert rng.fold_in(rng.key(seed), data) == tuple(int(x) for x in want)


@pytest.mark.parametrize("sample,bounce,offset", [(0, 0, 0), (5, 3, 0),
                                                  (1234, 7, 99)])
def test_fast_uniforms_bit_equal(sample, bounce, offset):
    key = jax.random.fold_in(jax.random.key(3), np.uint32(17))
    pk = tuple(int(x) for x in jax.random.key_data(key))
    want = np.asarray(jrng.fast_uniforms(key, jnp.int32(sample), bounce,
                                         (777,), 3, lane_offset=offset))
    got = rng.fast_uniforms(pk, sample, bounce, 777, 3, lane_offset=offset)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("sample", [0, 1, 1000, 2**20])
def test_r2_jitter_bit_equal(sample):
    key = jax.random.key(9)
    ids = np.arange(0, 5000, 3, dtype=np.int32)
    ju, jv = jrng.r2_jitter(key, jnp.asarray(ids), jnp.int32(sample))
    pu, pv = rng.r2_jitter(rng.key(9), torch.from_numpy(ids), sample)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
