"""Port flash attention against the JAX reference on the CPU.

The JAX side runs ``skypilot_tpu.ops.pallas.flash_attention`` in the
Pallas interpreter, as its own tests do; the port runs the plain PyTorch
versions of its kernels through the same ``autograd.Function`` the card
uses. Inputs come from seeded numpy. Tolerances: fp32 forward 2e-5 and
gradients 1e-4 (sums in another order); bf16 forward 2e-2 and gradients
2e-1 (``bench.py:_kernels_smoke``; P is rounded to bf16 before P.V on
both sides, at other points of the online softmax).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.attention import xla_attention as j_xla_attention
from skypilot_tpu.ops.pallas import flash_attention as jfa
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops.attention import (multi_head_attention,
                                              xla_attention)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

TOL = {'float32': (2e-5, 1e-4), 'bfloat16': (2e-2, 2e-1)}


def _inputs(shape, seed, segments=False):
    b, s, h, kv, d = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kv, d).astype(np.float32)
    v = rng.randn(b, s, kv, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)
    seg = None
    if segments:
        # documents of random lengths per row
        seg = np.stack([np.cumsum(rng.rand(s) < 0.02) for _ in range(b)])
        seg = seg.astype(np.int32)
    return q, k, v, do, seg


def _jax_side(q, k, v, do, seg, causal, dtype):
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal,
                                   segment_ids=jseg)

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do).astype(jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + grads]


def _torch_side(q, k, v, do, seg, causal, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    tseg = None if seg is None else torch.from_numpy(seg)
    out = tfa.flash_attention(*leaves, causal=causal, segment_ids=tseg)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt))
    return [x.detach().float().numpy() for x in (out,) + grads]


@pytest.mark.parametrize('shape,causal,segments,dtype', [
    ((1, 256, 2, 1, 128), True, False, 'float32'),
    ((1, 256, 2, 1, 128), False, False, 'float32'),
    ((2, 256, 4, 2, 128), True, True, 'float32'),
    ((2, 256, 4, 2, 128), False, True, 'float32'),
    ((1, 256, 2, 1, 128), True, False, 'bfloat16'),
    ((2, 256, 4, 2, 128), True, True, 'bfloat16'),
], ids=['causal', 'full', 'seg-causal', 'seg-full', 'bf16-causal',
        'bf16-seg'])
def test_flash_attention_and_grads_match_jax(shape, causal, segments,
                                             dtype):
    q, k, v, do, seg = _inputs(shape, seed=sum(shape), segments=segments)
    ref = _jax_side(q, k, v, do, seg, causal, dtype)
    out = _torch_side(q, k, v, do, seg, causal, dtype)
    fwd_tol, grad_tol = TOL[dtype]
    for i, (got, want) in enumerate(zip(out, ref)):
        tol = fwd_tol if i == 0 else grad_tol
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=['o', 'dq', 'dk', 'dv'][i])


@pytest.mark.parametrize('segments', [False, True], ids=['plain', 'seg'])
def test_forward_lse_matches_jax_kernel(segments):
    """The plain forward's lse against the Pallas forward's own."""
    q, k, v, _, seg = _inputs((2, 256, 4, 2, 128), seed=3,
                              segments=segments)
    jo, jlse = jfa._fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                          for x in (q, k, v)), causal=True,
                        scale=128 ** -0.5,
                        segments=None if seg is None else jnp.asarray(seg))
    o, lse = tfa.flash_forward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


def _permuted_segments(rng, b, s):
    """Documents of random lengths per row, renumbered by a random
    permutation per row: segment ids that do not increase along a row."""
    seg = np.stack([np.cumsum(rng.rand(s) < 0.03) for _ in range(b)])
    return np.stack([rng.permutation(s + 1)[row] for row in seg]).astype(
        np.int32)


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_forward_matches_jax_with_non_increasing_segment_ids(causal):
    """Segment ids in any order along a row: the plain forward, which
    the card holds the kernel's segment-tile skip to, against the
    Pallas forward."""
    q, k, v, _, _ = _inputs((2, 256, 4, 2, 128), seed=21)
    seg = _permuted_segments(np.random.RandomState(21), 2, 256)
    assert (np.diff(seg, axis=1) < 0).any()
    jo, jlse = jfa._fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                          for x in (q, k, v)), causal=causal,
                        scale=128 ** -0.5, segments=jnp.asarray(seg))
    o, lse = tfa.flash_forward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=2e-5)


# The card checks' limit on the forward's tile error in bf16
# (chip_smoke.py's FLASH_TOL, tests/test_torch_cuda.py).
BF16_FWD_LIMIT = 5e-2


def _tile_err(got, ref):
    """Max over 64-row tiles of one head of max|got - ref| / max|ref|
    (chip_smoke.py's tile_err), for [B, S, H, D] outputs."""
    b, s, h, d = ref.shape
    ref = ref.float()
    diff = (got.float() - ref).abs().reshape(b, s // 64, 64, h, d)
    scale = ref.abs().reshape(b, s // 64, 64, h, d).amax((2, 4))
    return (diff.amax((2, 4)) / scale.clamp_min(1e-30)).max().item()


def _forward_without(q, k, v, causal, seg, rows, keys):
    """The plain forward's o with the keys ``keys`` also masked for
    query rows ``rows`` of batch 0, head 0: what a kernel that skipped
    that key tile for that q tile would write."""
    b, s, h, d = q.shape
    sc, _ = tfa._scores(q, k, causal, seg)
    sc[0, 0, 0, rows, keys] = tfa.NEG_INF
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum('bhgqk,bkhd->bhgqd', p.to(v.dtype).float(), v.float())
    return ((acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
            .to(q.dtype))


@pytest.mark.parametrize('segments', [None, 'ordered', 'permuted'])
def test_forward_tile_faults_exceed_bf16_limit(segments):
    """The forward faults the card check plants: a q tile's o computed
    without keys 64-127 (without segments), or without the key tile that
    shares the most of its documents (a tile skip that misjudged the
    ids), fail the bf16 tile-error limit that the kernel must pass."""
    q, k, v, _, seg = _inputs((1, 256, 4, 2, 128), seed=22,
                              segments=segments == 'ordered')
    if segments == 'permuted':
        seg = _permuted_segments(np.random.RandomState(22), 1, 256)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    for causal in (True, False):
        ref, _ = tfa.flash_forward_reference(q, k, v, causal=causal,
                                             segment_ids=tseg)
        rows = slice(192, 256)
        keys = slice(64, 128)
        if tseg is not None:
            mask = tfa._mask(256, q.device, causal, tseg)[0, 0, 0, rows]
            kt = int(mask.reshape(64, 4, 64).sum((0, 2)).argmax())
            keys = slice(64 * kt, 64 * kt + 64)
        bad = _forward_without(q, k, v, causal, tseg, rows, keys)
        assert _tile_err(bad, ref) > BF16_FWD_LIMIT


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_xla_attention_with_segments_matches_jax(causal):
    q, k, v, _, seg = _inputs((2, 48, 4, 2, 16), seed=5, segments=True)
    ref = j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, segment_ids=jnp.asarray(seg))
    out = xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal,
                        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_gate_falls_back_with_one_warning(caplog, monkeypatch):
    """A sequence that is not a multiple of 128 leaves the kernel's
    gate: one warning, then the reference attention, as in JAX."""
    from skypilot_tpu_torch.ops import common
    monkeypatch.setattr(common, '_warned_fallbacks', set())
    q, k, v, _, _ = _inputs((1, 200, 2, 1, 128), seed=6)
    assert not tfa._supported(torch.from_numpy(q), torch.from_numpy(k))
    assert not jfa._supported(jnp.asarray(q), jnp.asarray(k), 200, 200)
    before = dict(tfa.FALLBACKS)
    with caplog.at_level(logging.WARNING):
        out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    warnings = [r for r in caplog.records if 'falling back' in r.message]
    assert len(warnings) == 1  # once per reason
    # every call counts, so a run can show that none left the kernels
    assert tfa.FALLBACKS == dict(before, cpu=before['cpu'] + 2)
    ref = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_invalid_gqa_raises():
    q = torch.zeros((1, 128, 3, 128))
    kv = torch.zeros((1, 128, 2, 128))
    assert not tfa._supported(q, kv)
    with pytest.raises(ValueError, match='multiple'):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(AssertionError):
        jfa.flash_attention(jnp.zeros((1, 128, 3, 128)),
                            jnp.zeros((1, 128, 2, 128)),
                            jnp.zeros((1, 128, 2, 128)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a plain version: CPU tensors raise
    (the autograd Function, not the wrapper, picks the plain path)."""
    q, k, v, do, _ = _inputs((1, 128, 2, 1, 128), seed=7)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_forward_kernel(q, k, v)
    o, lse = tfa.flash_forward_reference(q, k, v)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_backward_kernel(q, k, v, o, lse, do)


def test_dispatch_impls():
    q, k, v, _, seg = _inputs((1, 128, 2, 1, 128), seed=8, segments=True)
    q, k, v, seg = (torch.from_numpy(x) for x in (q, k, v, seg))
    flash = multi_head_attention(q, k, v, segment_ids=seg, impl='pallas')
    auto = multi_head_attention(q, k, v, segment_ids=seg, impl='auto')
    ref = multi_head_attention(q, k, v, segment_ids=seg, impl='xla')
    assert torch.equal(flash, auto)
    assert (flash - ref).abs().max().item() <= 2e-5
    # Without a seq mesh the sequence-parallel paths are the flash
    # attention (tests/test_torch_ring_attention.py holds them on one).
    for impl in ('ring', 'ulysses'):
        assert torch.equal(multi_head_attention(q, k, v, segment_ids=seg,
                                                impl=impl), flash)
    with pytest.raises(ValueError, match='Unknown'):
        multi_head_attention(q, k, v, impl='nope')
