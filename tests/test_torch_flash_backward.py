"""The flash backward's interfaces and plain versions on the CPU.

The dq kernel computes ``delta = rowsum(do * o)`` and hands it to the
dk/dv kernel, and the backward's shared-memory ring has edge shapes (one
64-row tile, a tile count that is no multiple of its two stages, GQA
groups of 1 and 8). Here the plain versions the card holds the kernels
to are held to the JAX reference at those shapes: ``_fwd`` / ``_bwd``
of ``skypilot_tpu.ops.pallas.flash_attention`` in the Pallas
interpreter, called directly because the public entry's gate needs
S % 128 == 0. Tolerances as in ``test_torch_flash_attention.py``: fp32
forward 2e-5, gradients 1e-4 (sums in another order). The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as jfa
from skypilot_tpu_torch import _build
from skypilot_tpu_torch.ops import flash_attention as tfa
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
# bf16 gradient limit of the card checks (tile error; chip_smoke.py's
# FLASH_TOL and tests/test_torch_cuda.py).
BF16_GRAD_LIMIT = 5e-2


def _inputs(b, s, h, kvh, d, seed, segments):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    seg = None
    if segments:
        seg = np.stack([np.cumsum(rng.rand(s) < 0.03) for _ in range(b)])
        seg = seg.astype(np.int32)
    return q, k, v, do, seg


def _tile_err(got, ref):
    """Max over 64-row tiles of one head of max|got - ref| / max|ref|
    (chip_smoke.py's tile_err), for [B, S, H, D] outputs."""
    b, s, h, d = ref.shape
    ref = ref.float()
    diff = (got.float() - ref).abs().reshape(b, s // 64, 64, h, d)
    scale = ref.abs().reshape(b, s // 64, 64, h, d).amax((2, 4))
    return (diff.amax((2, 4)) / scale.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize('s,h,kvh,causal,segments', [
    (64, 4, 4, True, True), (64, 16, 2, False, False),
    (192, 16, 2, True, False), (192, 4, 4, False, True),
    (192, 8, 1, True, True)],
    ids=['S64-G1-causal-seg', 'S64-G8-full', 'S192-G8-causal',
         'S192-G1-full-seg', 'S192-G8-causal-seg'])
def test_plain_backward_matches_jax_at_ring_edges(s, h, kvh, causal,
                                                  segments):
    q, k, v, do, seg = _inputs(1, s, h, kvh, 128, seed=s + h,
                               segments=segments)
    scale = 128 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    jo, jlse = jfa._fwd(jq, jk, jv, causal=causal, scale=scale,
                        segments=jseg)
    if jseg is None:
        jgrads = jfa._bwd(causal, scale, (jq, jk, jv, jo, jlse), jdo)
    else:
        jgrads = jfa._bwd_seg(causal, scale, (jq, jk, jv, jo, jlse, jseg),
                              jdo)[:3]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tfa.flash_forward_reference(tq, tk, tv, causal=causal,
                                         segment_ids=tseg)
    grads = tfa.flash_backward_reference(tq, tk, tv, o, lse, tdo,
                                         causal=causal, segment_ids=tseg)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, got, want in zip(('dq', 'dk', 'dv'), grads, jgrads):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 2, 1, 3),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_plain_delta_matches_jax():
    """``_delta``, the plain version of the dq kernel's delta output,
    is the reference's ``sum(do * o)`` in fp32, laid out [B, H, S]."""
    q, _, _, do, _ = _inputs(2, 64, 4, 2, 128, seed=11, segments=False)
    o = q  # any [B, S, H, D] tensor
    want = jnp.sum(jnp.asarray(do) * jnp.asarray(o), axis=-1)
    got = tfa._delta(torch.from_numpy(o).bfloat16(),
                     torch.from_numpy(do).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (2, 4, 64)
    ref = tfa._delta(torch.from_numpy(o), torch.from_numpy(do))
    np.testing.assert_allclose(ref.numpy(),
                               np.asarray(want).transpose(0, 2, 1),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_delta_fault_exceeds_bf16_limit(causal):
    """dq and dk computed with delta off by 1 (about its mean magnitude)
    pass the bf16 gradient limit no more, so the card checks catch a
    wrong delta; dv takes no delta."""
    q, k, v, do, _ = _inputs(1, 256, 4, 2, 128, seed=12, segments=False)
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o, lse = tfa.flash_forward_reference(q, k, v, causal=causal)
    p, ds, qg, dog = tfa._probs(q, k, v, o, lse, do, causal, None)
    bad = ds - 1.0 * p
    rdq = tfa._dq(ds, q, k)
    rdk, rdv = tfa._dkv(p, ds, qg, dog, k, v)
    bad_dk, bad_dv = tfa._dkv(p, bad, qg, dog, k, v)
    assert _tile_err(tfa._dq(bad, q, k), rdq) > BF16_GRAD_LIMIT
    assert _tile_err(bad_dk, rdk) > BF16_GRAD_LIMIT
    assert torch.equal(bad_dv, rdv)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    """dq (which now takes o and returns delta) and dk/dv raise on CPU
    tensors before any work, naming CUDA."""
    q, k, v, do, _ = _inputs(1, 128, 2, 1, 128, seed=13, segments=False)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_forward_reference(q, k, v)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_dq_kernel(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_dkv_kernel(q, k, v, lse, do, tfa._delta(o, do))


def test_library_binds_the_backward_c_interface(monkeypatch):
    """The wrappers load the flash library once and bind its C
    interface: the forward takes the query and the key rows' segment ids
    (7 pointers), dq takes o and writes delta (10 pointers), dk/dv reads
    delta (10 pointers)."""
    asked = []

    def fake_load(name):
        asked.append(name)
        return types.SimpleNamespace(**{
            fn: types.SimpleNamespace()
            for fn in ('skyt_flash_fwd', 'skyt_flash_bwd_dq',
                       'skyt_flash_bwd_dkv')})

    monkeypatch.setattr(_build, 'load_library', fake_load)
    monkeypatch.setattr(tfa, '_lib', None)
    lib = tfa._library()
    assert tfa._library() is lib
    assert asked == ['flash_attention']
    assert len(lib.skyt_flash_fwd.argtypes) == 7 + 6 + 3
    assert len(lib.skyt_flash_bwd_dq.argtypes) == 10 + 6 + 3
    assert len(lib.skyt_flash_bwd_dkv.argtypes) == 10 + 6 + 3
