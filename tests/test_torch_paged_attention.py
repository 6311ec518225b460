"""Port paged attention (plain version) against the JAX reference.

The same seeded numpy pools, shuffled non-contiguous block tables,
ragged and block-boundary lengths, GQA groups and verify windows go
through the port's ``paged_attention`` (CPU tensors -> its plain
version) and through both JAX references: the gathered-view XLA oracle
``xla_paged_attention`` and the Pallas kernel itself
(``impl='pallas'``, interpret mode on the CPU). Tolerance 2e-5, the
reference's own bound; int8 pools are compared on the same int8 data.
A bf16 pool is held to the Pallas kernel by its mean error, which shows
whether P is rounded to bf16 before P.V as the kernel rounds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas.paged_attention import (paged_attention,
                                                     xla_paged_attention)
from skypilot_tpu_torch.models.decode import quantize_kv
from skypilot_tpu_torch.ops import paged_attention as tpa
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

RAGGED = [1, 9, 24, 48]
BOUNDARY = [8, 16, 32, 40]
ATOL = 2e-5


def _setup(g, q_len, seed, b=4, kvh=2, d=16, bs=8, bps=6):
    rng = np.random.RandomState(seed)
    nb = b * bps + 1
    k_pool = rng.randn(nb, bs, kvh, d).astype(np.float32)
    v_pool = rng.randn(nb, bs, kvh, d).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb))
    bt = perm[:b * bps].reshape(b, bps).astype(np.int32)
    q = rng.randn(b, q_len, kvh * g, d).astype(np.float32)
    return q, k_pool, v_pool, bt


def _port(q, k_pool, v_pool, bt, nv, ks=None, vs=None):
    t = torch.from_numpy
    out = tpa.paged_attention(
        t(q), t(k_pool), t(v_pool), t(bt), t(nv),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs))
    return out.numpy()


def _live_rows(nv, q_len):
    """[B, Q] mask of query rows that see at least one valid row (the
    gathered-view oracle spreads a fully masked row over the whole
    view, the kernel over the blocks it reads)."""
    nv = np.asarray(nv)[:, None]
    return nv - (q_len - 1) + np.arange(q_len)[None, :] > 0


@pytest.mark.parametrize('q_len', [1, 3])
@pytest.mark.parametrize('g', [1, 2, 4])
@pytest.mark.parametrize('lengths', [RAGGED, BOUNDARY],
                         ids=['ragged', 'boundary'])
def test_plain_matches_reference_fp32(lengths, g, q_len):
    q, k_pool, v_pool, bt = _setup(g, q_len, seed=g * 10 + q_len)
    nv = np.asarray(lengths, np.int32)
    j = jnp.asarray
    out = _port(q, k_pool, v_pool, bt, nv)
    pallas = paged_attention(j(q), j(k_pool), j(v_pool), j(bt), j(nv),
                             impl='pallas')
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)
    oracle = np.asarray(xla_paged_attention(j(q), j(k_pool), j(v_pool),
                                            j(bt), j(nv)))
    live = _live_rows(nv, q_len)
    np.testing.assert_allclose(out[live], oracle[live], atol=ATOL)


@pytest.mark.parametrize('q_len', [1, 3])
@pytest.mark.parametrize('lengths', [RAGGED, BOUNDARY],
                         ids=['ragged', 'boundary'])
def test_plain_matches_reference_int8(lengths, q_len):
    q, k_pool, v_pool, bt = _setup(2, q_len, seed=7 + q_len)
    kq, ks = (x.numpy() for x in quantize_kv(torch.from_numpy(k_pool)))
    vq, vs = (x.numpy() for x in quantize_kv(torch.from_numpy(v_pool)))
    nv = np.asarray(lengths, np.int32)
    j = jnp.asarray
    out = _port(q, kq, vq, bt, nv, ks, vs)
    pallas = paged_attention(j(q), j(kq), j(vq), j(bt), j(nv),
                             k_scale=j(ks), v_scale=j(vs), impl='pallas')
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)
    oracle = np.asarray(xla_paged_attention(j(q), j(kq), j(vq), j(bt),
                                            j(nv), k_scale=j(ks),
                                            v_scale=j(vs)))
    live = _live_rows(nv, q_len)
    np.testing.assert_allclose(out[live], oracle[live], atol=ATOL)


# bf16: the Pallas kernel rounds P against each block's running max, the
# plain version against the row's max, so outputs still differ by an
# output ulp here and there: mean |port - Pallas| reads 1.1e-4 to 1.3e-4
# with P rounded and 2.5e-4 to 2.7e-4 without (seeds 21-23, Q=1 and 3),
# and no output may differ by more than one ulp at its size (< 2).
BF16_MEAN_ATOL = 1.6e-4
BF16_MAX_ATOL = 2 ** -7


@pytest.mark.parametrize('q_len', [1, 3])
def test_plain_rounds_p_like_reference_bf16(q_len):
    q, k_pool, v_pool, bt = _setup(4, q_len, seed=21, d=64, bps=8)
    nv = np.asarray([5, 17, 40, 64], np.int32)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (q, k_pool, v_pool))
    out = tpa.paged_attention(qb, kb, vb, torch.from_numpy(bt),
                              torch.from_numpy(nv)).float().numpy()

    def j(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    pallas = paged_attention(j(qb), j(kb), j(vb), jnp.asarray(bt),
                             jnp.asarray(nv), impl='pallas')
    diff = np.abs(out - np.asarray(pallas.astype(jnp.float32)))
    assert diff.mean() <= BF16_MEAN_ATOL, diff.mean()
    assert diff.max() <= BF16_MAX_ATOL, diff.max()


def test_split_rule_fills_the_card_without_reading_lengths():
    """The kernel's split count comes from (B, KVH, BPS) alone: as many
    CTAs as stay resident at once at small batch, one split once B * KVH
    fills that, never more splits than blocks or than one cluster
    takes."""
    for b, kvh, bps in [(1, 8, 128), (4, 8, 128), (8, 8, 128),
                        (40, 8, 128), (128, 8, 128), (8, 8, 3),
                        (1, 1, 1)]:
        s = tpa._num_splits(b, kvh, bps)
        assert 1 <= s <= min(bps, tpa._MAX_SPLITS)
        if b * kvh >= tpa._WAVE_CTAS:
            assert s == 1
        elif s < min(bps, tpa._MAX_SPLITS):
            assert b * kvh * s <= tpa._WAVE_CTAS
            assert b * kvh * (s + 1) > tpa._WAVE_CTAS
    assert tpa._num_splits(128, 8, 128) == 1
    assert tpa._num_splits(8, 8, 128) > 1


def test_fully_masked_padded_rows_are_finite_and_match_kernel():
    """An inactive slot in a verify step has n_valid = 1 with Q = 3:
    its first two query rows see no valid row. With the finite NEG_INF
    they average the rows of the blocks read, exactly as the Pallas
    kernel does, and never turn NaN."""
    q, k_pool, v_pool, bt = _setup(2, 3, seed=11)
    nv = np.asarray([1, 2, 3, 30], np.int32)
    j = jnp.asarray
    out = _port(q, k_pool, v_pool, bt, nv)
    assert np.isfinite(out).all()
    pallas = paged_attention(j(q), j(k_pool), j(v_pool), j(bt), j(nv),
                             impl='pallas')
    np.testing.assert_allclose(out, np.asarray(pallas), atol=ATOL)
    # Slot 0, row 0: uniform over the 8 rows of the one block read.
    expected = v_pool[bt[0, 0]].mean(axis=0)              # [KVH, D]
    np.testing.assert_allclose(out[0, 0].reshape(2, 2, 16)[:, 0],
                               expected, atol=ATOL)


def test_stale_rows_never_leak():
    """Rows past n_valid must not influence the output, whatever they
    hold."""
    q, k_pool, v_pool, bt = _setup(2, 1, seed=12)
    nv = np.asarray([5, 9, 17, 30], np.int32)
    clean = _port(q, k_pool, v_pool, bt, nv)
    k_dirty, v_dirty = k_pool.copy(), v_pool.copy()
    for slot in range(bt.shape[0]):
        for idx, blk in enumerate(bt[slot]):
            for r in range(k_pool.shape[1]):
                if idx * k_pool.shape[1] + r >= nv[slot]:
                    k_dirty[blk, r] = 7e3
                    v_dirty[blk, r] = -7e3
    np.testing.assert_array_equal(
        clean, _port(q, k_dirty, v_dirty, bt, nv))


def test_dispatch_refuses_mixed_devices_and_bad_heads():
    q, k_pool, v_pool, bt = _setup(2, 1, seed=13)
    t = torch.from_numpy
    with pytest.raises(ValueError, match='multiple'):
        tpa.paged_attention(t(q[:, :, :3]), t(k_pool), t(v_pool), t(bt),
                            t(np.ones(4, np.int32)))
    with pytest.raises(ValueError, match='together'):
        tpa.paged_attention(t(q), t(k_pool), t(v_pool), t(bt),
                            t(np.ones(4, np.int32)),
                            k_scale=torch.ones(1))
