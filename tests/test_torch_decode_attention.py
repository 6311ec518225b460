"""The port's decode attention against the JAX reference, on the CPU.

The same numpy-seeded q, k, v and lengths go through JAX's
``decode_attention(impl='pallas')`` (the Pallas kernel in interpret
mode, as the reference's own tests run it), JAX's
``xla_decode_attention`` and the port's ``decode_attention`` on CPU
tensors (its plain version). Cases mirror
``tests/test_decode_attention.py`` and the int8 case of
``tests/test_kv_cache_int8.py``. Tolerances are the reference's: 2e-5 at
fp32, 2e-2 at bf16. Fully masked query rows of a Q-window (discarded by
contract) are uniform over the blocks read in the Pallas kernel and over
all T rows in both plain versions, so against the kernel they are left
out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode_attention)
from skypilot_tpu.ops.pallas.decode_attention import (
    xla_decode_attention as jax_xla_decode_attention)
from skypilot_tpu_torch.ops import decode_attention as da
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _inputs(b=2, t=64, h=4, kvh=2, d=16, q_len=1, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, q_len, h, d).astype(np.float32)
    k = rng.randn(b, t, kvh, d).astype(np.float32)
    v = rng.randn(b, t, kvh, d).astype(np.float32)
    return q, k, v


def _port(q, k, v, lengths, k_scale=None, v_scale=None, dtype=None,
          impl='auto'):
    def t(x):
        x = torch.from_numpy(np.array(x, np.float32)
                             if dtype is not None else np.array(x))
        return x.to(dtype) if dtype is not None else x
    before = dict(da.LAUNCHES)
    out = da.decode_attention(
        t(q), t(k), t(v), torch.tensor(lengths, dtype=torch.int32),
        k_scale=None if k_scale is None else torch.from_numpy(
            np.array(k_scale)),
        v_scale=None if v_scale is None else torch.from_numpy(
            np.array(v_scale)),
        impl=impl)
    assert da.LAUNCHES == before          # CPU tensors never launch
    return out.float().numpy()


def _jax(q, k, v, lengths, block_k, dtype=jnp.float32, **scales):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    n_valid = jnp.asarray(lengths, jnp.int32)
    kernel = jax_decode_attention(*args, n_valid, impl='pallas',
                                  block_k=block_k, **scales)
    plain = jax_xla_decode_attention(*args, n_valid, scales.get('k_scale'),
                                     scales.get('v_scale'))
    return (np.asarray(kernel, np.float32), np.asarray(plain, np.float32))


def _live(lengths, q_len):
    limit = np.asarray(lengths)[:, None] - (q_len - 1) + np.arange(q_len)
    return (limit > 0)[..., None, None]


@pytest.mark.parametrize('lengths', [[1, 1], [5, 33], [64, 17], [64, 64]])
def test_matches_reference_kernel_and_plain(lengths):
    q, k, v = _inputs()
    out = _port(q, k, v, lengths)
    kernel, plain = _jax(q, k, v, lengths, block_k=16)
    np.testing.assert_allclose(out, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('h,kvh', [(4, 4), (8, 2), (8, 1)])
def test_gqa_groupings(h, kvh):
    q, k, v = _inputs(h=h, kvh=kvh, seed=1)
    out = _port(q, k, v, [40, 23])
    kernel, plain = _jax(q, k, v, [40, 23], block_k=32)
    np.testing.assert_allclose(out, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


def test_stale_tail_rows_never_leak():
    """Rows at or past n_valid must not move the output even when they
    hold +-1e4 (a recycled slot)."""
    q, k, v = _inputs(seed=2)
    pk, pv = k.copy(), v.copy()
    pk[:, 10:] = 1e4
    pv[:, 10:] = -1e4
    clean = _port(q, k, v, [10, 10])
    poisoned = _port(q, pk, pv, [10, 10])
    np.testing.assert_allclose(poisoned, clean, rtol=1e-6, atol=1e-7)
    kernel, _ = _jax(q, pk, pv, [10, 10], block_k=16)
    np.testing.assert_allclose(poisoned, kernel, rtol=2e-5, atol=2e-5)


def test_bf16_inputs():
    q, k, v = _inputs(seed=3)
    out = _port(q, k, v, [48, 31], dtype=torch.bfloat16)
    kernel, plain = _jax(q, k, v, [48, 31], block_k=16,
                         dtype=jnp.bfloat16)
    np.testing.assert_allclose(out, kernel, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out, plain, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize('lengths', [[5, 40], [2, 64]])
def test_q3_window(lengths):
    """A Q=3 verify window: query j attends pos < n_valid - (2 - j). With
    n_valid = 2 the first window row attends nothing."""
    q, k, v = _inputs(q_len=3, seed=4)
    out = _port(q, k, v, lengths)
    kernel, plain = _jax(q, k, v, lengths, block_k=16)
    live = _live(lengths, 3)
    np.testing.assert_allclose(out * live, kernel * live, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


def test_t_off_a_power_of_two():
    """T = 72 (the batch engine's T = prompt bucket + decode bucket is
    off the kernel's tile too): the reference refits its block to 8."""
    q, k, v = _inputs(t=72, seed=5)
    out = _port(q, k, v, [70, 9])
    kernel, plain = _jax(q, k, v, [70, 9], block_k=16)
    np.testing.assert_allclose(out, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('lengths', [[5, 33], [64, 17]])
def test_int8_cache_scales(lengths):
    q, k, v = _inputs(seed=6)
    k_q, k_s = jdecode.quantize_kv(jnp.asarray(k))
    v_q, v_s = jdecode.quantize_kv(jnp.asarray(v))
    k_q, k_s, v_q, v_s = (np.asarray(x) for x in (k_q, k_s, v_q, v_s))
    out = _port(q, k_q, v_q, lengths, k_scale=k_s, v_scale=v_s)
    n_valid = jnp.asarray(lengths, jnp.int32)
    kernel = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(v_q), n_valid,
        k_scale=jnp.asarray(k_s), v_scale=jnp.asarray(v_s), impl='pallas',
        block_k=16)
    plain = jax_xla_decode_attention(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(v_q), n_valid,
        jnp.asarray(k_s), jnp.asarray(v_s))
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(plain), rtol=2e-5,
                               atol=2e-5)


def test_explicit_xla_impl_is_the_plain_version():
    q, k, v = _inputs(seed=7)
    auto = _port(q, k, v, [30, 64])
    xla = _port(q, k, v, [30, 64], impl='xla')
    np.testing.assert_array_equal(auto, xla)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never runs the plain version: CPU tensors raise there,
    and only the dispatch sends them to ``xla_decode_attention``."""
    qg = torch.zeros((1, 2, 4, 64))
    cache = torch.zeros((1, 32, 2, 64))
    before = dict(da.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA'):
        da.decode_attention_kernel(qg, cache, cache,
                                   torch.ones((1,), dtype=torch.int32), 1)
    assert da.LAUNCHES == before


def test_mismatched_scales_and_heads_raise():
    q, k, v = _inputs()
    t = [torch.from_numpy(x) for x in (q, k, v)]
    n_valid = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match='together'):
        da.decode_attention(*t, n_valid, k_scale=torch.ones((2, 64, 2)))
    with pytest.raises(ValueError, match='multiple'):
        da.decode_attention(t[0][:, :, :3], t[1], t[2], n_valid)


@pytest.mark.parametrize('b,kvh,t,want', [
    (1, 8, 2048, 4), (4, 8, 288, 4), (8, 8, 2048, 4), (16, 8, 2048, 2),
    (40, 8, 2048, 1), (128, 8, 2048, 1), (8, 8, 40, 3), (1, 1, 1, 1),
    (4, 2, 300, 4), (33, 4, 2048, 2), (8, 8, 16, 1)])
def test_split_rule_is_one_wave_of_at_most_four(b, kvh, t, want):
    """The kernels' split count comes from (B, KVH, T) alone, never from
    the lengths: as many CTAs as stay resident at once (one wave) at
    small batch, one split once B * KVH fills the wave, at least 1, at
    most 4 (one cluster) and never more than the 16-row tiles of T."""
    s = da._num_splits(b, kvh, t)
    assert s == want
    assert 1 <= s <= min(-(-t // da._MMA_TILE), da._MAX_SPLITS)
    if s > 1:
        assert b * kvh * s <= da._WAVE_CTAS
    if s < min(-(-t // da._MMA_TILE), da._MAX_SPLITS):
        assert s == 1 or b * kvh * (s + 1) > da._WAVE_CTAS


@pytest.mark.parametrize('q_dtype,kv_dtype,qgr,d,want', [
    (torch.bfloat16, torch.bfloat16, 4, 128, 1),     # llama3-8b decode
    (torch.bfloat16, torch.int8, 4, 128, 1),
    (torch.bfloat16, torch.bfloat16, 16, 256, 1),
    (torch.bfloat16, torch.bfloat16, 20, 128, 2),    # Q=5 verify window
    (torch.bfloat16, torch.int8, 32, 64, 2),
    (torch.bfloat16, torch.bfloat16, 32, 256, 0),    # too wide at D=256
    (torch.bfloat16, torch.int8, 33, 128, 0),        # wider than 2 tiles
    (torch.float32, torch.float32, 4, 128, 0),       # fp32: CUDA cores
    (torch.float32, torch.int8, 4, 128, 0)])
def test_route_by_dtype_and_shape(q_dtype, kv_dtype, qgr, d, want):
    """The kernel a call runs is chosen on the host before the launch,
    from the dtypes, Q*G and D alone: 16-row query tiles on tensor cores
    for bf16 queries, 0 for the CUDA-core kernel."""
    assert da._mma_tiles(q_dtype, kv_dtype, qgr, d) == want
