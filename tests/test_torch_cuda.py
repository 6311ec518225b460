"""Port kernels on the card: the Hopper paged-, decode- and
flash-attention kernels against their plain PyTorch versions, the W8A8
int8 products, and the engines' kernel paths against their CPU paths.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip.
Run them on the card with::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import pytest
import torch

from skypilot_tpu_torch.models.decode import quantize_kv
from skypilot_tpu_torch.models.quant import _quantize_activations
from skypilot_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU '
                    'mode (their plain versions are tested on the CPU)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _case(card, dtype, quant, q_len, d=128, g=4, kvh=2, bs=16, bps=8,
          lengths=(1, 15, 16, 17, 100, 128)):
    gen = torch.Generator(device=card)
    gen.manual_seed(q_len * 10 + d)
    b = len(lengths)
    nb = b * bps + 1
    k = torch.randn((nb, bs, kvh, d), generator=gen, device=card)
    v = torch.randn((nb, bs, kvh, d), generator=gen, device=card)
    q = torch.randn((b, q_len, kvh * g, d), generator=gen,
                    device=card).to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device=card) + 1
    bt = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    nv = torch.tensor(lengths, dtype=torch.int32, device=card)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return q, k, v, bt, nv, ks, vs
    return q, k.to(dtype), v.to(dtype), bt, nv, None, None


# Limits on the paged kernels' error normalized per (sequence, head), as
# chip_smoke.py's PAGED_TOL: bf16 outputs round at 2^-8 relative (2^-7
# of the largest element when a rounding flips); fp32 sums differ in
# order only.
PAGED_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _head_err(got, ref, nv):
    """max over (sequence, head) of max|got - ref| / max|ref| over its
    live query rows and head dims ([B, Q, H, D])."""
    keep = _live_rows(nv, ref.shape[1])
    ref = ref.float()
    diff = ((got.float() - ref).abs() * keep).amax(dim=(1, 3))
    scale = (ref.abs() * keep).amax(dim=(1, 3)).clamp_min(1e-30)
    return (diff / scale).max().item()


@pytest.mark.parametrize('splits', [None, 1, 3],
                         ids=['picked', 'splits1', 'splits3'])
@pytest.mark.parametrize('d', [64, 128, 256])
@pytest.mark.parametrize('q_len', [1, 3])
@pytest.mark.parametrize('dtype,quant', [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=['bf16', 'fp32', 'int8'])
def test_kernel_matches_plain(card, monkeypatch, dtype, quant, q_len, d,
                              splits):
    """The wrapper's split count (4 here: B * KVH = 12 pairs), one CTA
    per (sequence, kv head), and three, which share a slot's blocks
    unevenly (the 100-row slot's 7 blocks as 3, 3, 1)."""
    if splits is not None:
        # B * KVH = 12 pairs: a wave of 12 CTAs gives 1 split, of 36 gives 3
        monkeypatch.setattr(pa, '_WAVE_CTAS', 12 * splits)
        assert pa._num_splits(6, 2, 8) == splits
    q, k, v, bt, nv, ks, vs = _case(card, dtype, quant, q_len, d=d)
    name = 'paged_attention_quant' if quant else 'paged_attention'
    before = pa.LAUNCHES[name]
    out = pa.paged_attention(q, k, v, bt, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_attention_reference(q, k, v, bt, nv, ks, vs)
    assert torch.isfinite(out).all()
    assert _head_err(out, ref, nv) <= PAGED_TOL[dtype]


@pytest.mark.parametrize('q_len', [1, 3])
def test_kernel_repeats_and_empty_slots(card, q_len):
    """A second call gives bitwise the same output (the split merge
    leaves no state behind); a slot with n_valid = 0 gives 0; fully
    masked verify rows stay finite and match the plain version."""
    q, k, v, bt, nv, _, _ = _case(card, torch.bfloat16, False, q_len,
                                  lengths=(0, 1, 2, 100, 128, 33))
    first = pa.paged_attention(q, k, v, bt, nv)
    second = pa.paged_attention(q, k, v, bt, nv)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert first[0].abs().max().item() == 0
    ref = pa.paged_attention_reference(q, k, v, bt, nv)
    assert torch.isfinite(first).all()
    assert _head_err(first, ref, nv) <= PAGED_TOL[torch.bfloat16]
    masked = ~_live_rows(nv, q_len)[..., 0, 0]
    masked[0] = False  # n_valid = 0: nothing read, zeros
    if masked.any():
        got, want = first[masked].float(), ref[masked].float()
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= PAGED_TOL[torch.bfloat16]


def test_kernel_rejects_unsupported_shapes(card):
    q, k, v, bt, nv, _, _ = _case(card, torch.bfloat16, False, 1, d=64)
    with pytest.raises(ValueError, match='head dim'):
        pa.paged_attention(q[..., :32], k[..., :32].contiguous(),
                           v[..., :32].contiguous(), bt, nv)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_attention(q.half(), k.half(), v.half(), bt, nv)
    with pytest.raises(ValueError, match='int32'):
        pa.paged_attention(q, k, v, bt.long(), nv)


def _flash_case(card, dtype, d, seg, b=2, s=256, h=4, kvh=2):
    from skypilot_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=card)
    gen.manual_seed(d + 7 * seg)
    q, do = (torch.randn((b, s, h, d), generator=gen, device=card)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, kvh, d), generator=gen, device=card)
            .to(dtype) for _ in range(2))
    segments = None
    if seg:
        # documents of uneven lengths, cut off the 64-row tile grid
        bounds = torch.tensor([0, 37, 100, 101, 190], device=card)
        pos = torch.arange(s, device=card)
        segments = ((pos[None, :] >= bounds[:, None]).sum(0) - 1)
        segments = segments.to(torch.int32)[None].repeat(b, 1).contiguous()
    return fa, q, k, v, do, segments


# Limits on the tile error of (o and lse, gradients), as in chip_smoke.py:
# bf16 rounds P (and, in the kernels, ds) to 2^-8; fp32 sums differ in
# order only. A tile a kernel leaves unwritten reads 1.
FLASH_TOL = {torch.bfloat16: (5e-2, 5e-2), torch.float32: (1e-4, 1e-4)}


def _tile_err(got, ref):
    """Max over 64-row tiles of one head of max|got - ref| / max|ref|
    within the tile; [B, S, H, D] outputs or [B, H, S] lse."""
    if ref.dim() == 4:
        b, s, h, d = ref.shape
        shape, dims = (b, s // 64, 64, h, d), (2, 4)
    else:
        b, h, s = ref.shape
        shape, dims = (b, h, s // 64, 64), (3,)
    ref = ref.float()
    diff = (got.float() - ref).abs().reshape(shape).amax(dims)
    scale = ref.abs().reshape(shape).amax(dims).clamp_min(1e-30)
    return (diff / scale).max().item()


@pytest.mark.parametrize('seg', [False, True], ids=['plain', 'seg'])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
@pytest.mark.parametrize('d', [128, 256])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
def test_flash_kernels_match_plain(card, dtype, d, causal, seg):
    fa, q, k, v, do, segments = _flash_case(card, dtype, d, seg)
    suffix = '_seg' if seg else ''
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward_kernel(q, k, v, causal=causal,
                                     segment_ids=segments)
    grads = fa.flash_backward_kernel(q, k, v, o, lse, do, causal=causal,
                                     segment_ids=segments)
    torch.cuda.synchronize()
    for name in ('flash_fwd', 'flash_dq', 'flash_dkv'):
        assert fa.LAUNCHES[name + suffix] == before[name + suffix] + 1
    ro, rlse = fa.flash_forward_reference(q, k, v, causal=causal,
                                          segment_ids=segments)
    rgrads = fa.flash_backward_reference(q, k, v, ro, rlse, do,
                                         causal=causal,
                                         segment_ids=segments)
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    assert _tile_err(o, ro) <= fwd_tol
    assert _tile_err(lse, rlse) <= fwd_tol
    for got, ref in zip(grads, rgrads):
        assert got.dtype == ref.dtype and torch.isfinite(got).all()
        assert _tile_err(got, ref) <= grad_tol


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
@pytest.mark.parametrize('s', [192, 512], ids=['S192', 'S512'])
@pytest.mark.parametrize('d', [128, 256])
def test_flash_forward_non_increasing_segment_ids(card, d, s, causal):
    """The bf16 forward skips key tiles whose segment-id range misses the
    q tile's; with each row's documents renumbered at random (ids that
    do not increase along a row) it still matches plain, at one
    warpgroup a CTA (S=192) and two (S=512), both head dims."""
    fa, q, k, v, _, _ = _flash_case(card, torch.bfloat16, d, False, s=s,
                                    h=8, kvh=2)
    gen = torch.Generator(device=card)
    gen.manual_seed(s + d)
    starts = torch.rand((2, s), generator=gen, device=card) < 1 / 40
    seg = torch.cumsum(starts.int(), dim=1)
    perm = torch.stack([torch.randperm(s + 1, generator=gen, device=card)
                        for _ in range(2)])
    seg = torch.gather(perm, 1, seg.long()).to(torch.int32).contiguous()
    assert (seg.diff(dim=1) < 0).any()
    before = fa.LAUNCHES['flash_fwd_seg']
    o, lse = fa.flash_forward_kernel(q, k, v, causal=causal,
                                     segment_ids=seg)
    torch.cuda.synchronize()
    assert fa.LAUNCHES['flash_fwd_seg'] == before + 1
    ro, rlse = fa.flash_forward_reference(q, k, v, causal=causal,
                                          segment_ids=seg)
    fwd_tol = FLASH_TOL[torch.bfloat16][0]
    assert torch.isfinite(o).all()
    assert _tile_err(o, ro) <= fwd_tol
    assert _tile_err(lse, rlse) <= fwd_tol


def test_flash_attention_autograd_on_card(card):
    """The public entry runs the kernels both ways on CUDA tensors and
    agrees with its CPU (plain) path."""
    fa, q, k, v, do, segments = _flash_case(card, torch.float32, 128, True)
    before = dict(fa.LAUNCHES)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, segment_ids=segments)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa.LAUNCHES['flash_fwd_seg'] == before['flash_fwd_seg'] + 1
    assert fa.LAUNCHES['flash_dkv_seg'] == before['flash_dkv_seg'] + 1
    cpu = [x.detach().cpu().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention(*cpu, causal=True,
                             segment_ids=segments.cpu())
    rgrads = torch.autograd.grad(ref, cpu, do.cpu())
    assert (out.detach().cpu() - ref.detach()).abs().max().item() <= 2e-4
    for got, want in zip(grads, rgrads):
        assert (got.cpu() - want).abs().max().item() <= 2e-3


def test_flash_kernel_rejects_unsupported_inputs(card):
    fa, q, k, v, _, _ = _flash_case(card, torch.bfloat16, 128, False)
    with pytest.raises(ValueError, match='dtype'):
        fa.flash_forward_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_forward_kernel(q[:, ::2], k[:, ::2], v[:, ::2])
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_forward_kernel(
            torch.zeros((1, 128, 2, 384), device=card),
            torch.zeros((1, 128, 1, 384), device=card),
            torch.zeros((1, 128, 1, 384), device=card))


# The dq kernel's delta against the plain ``_delta``: the same fp32
# products summed in another order.
DELTA_TOL = 1e-4


@pytest.mark.parametrize('s,h,kvh,causal,seg', [
    (64, 4, 4, True, True), (64, 16, 2, False, False),
    (192, 16, 2, True, False), (192, 4, 4, False, True)],
    ids=['S64-G1-causal-seg', 'S64-G8-full', 'S192-G8-causal',
         'S192-G1-full-seg'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
def test_flash_backward_ring_edge_shapes(card, dtype, s, h, kvh, causal,
                                         seg):
    """The backward's cp.async ring at its edges: one 64-row tile (its
    prologue and epilogue only) and three (no multiple of the two
    stages), GQA groups of 1 and 8; the dq kernel's delta too."""
    fa, q, k, v, do, segments = _flash_case(card, dtype, 128, seg, s=s,
                                            h=h, kvh=kvh)
    o, lse = fa.flash_forward_kernel(q, k, v, causal=causal,
                                     segment_ids=segments)
    dq, delta = fa.flash_dq_kernel(q, k, v, o, lse, do, causal=causal,
                                   segment_ids=segments)
    dk, dv = fa.flash_dkv_kernel(q, k, v, lse, do, delta, causal=causal,
                                 segment_ids=segments)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_forward_reference(q, k, v, causal=causal,
                                          segment_ids=segments)
    rgrads = fa.flash_backward_reference(q, k, v, ro, rlse, do,
                                         causal=causal,
                                         segment_ids=segments)
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    assert _tile_err(o, ro) <= fwd_tol
    assert _tile_err(lse, rlse) <= fwd_tol
    assert _tile_err(delta, fa._delta(o, do)) <= DELTA_TOL
    for got, ref in zip((dq, dk, dv), rgrads):
        assert got.dtype == ref.dtype and torch.isfinite(got).all()
        assert _tile_err(got, ref) <= grad_tol


@pytest.mark.parametrize('seg', [False, True], ids=['plain', 'seg'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
def test_flash_backward_is_deterministic(card, dtype, seg):
    """No atomics: two backward calls give bitwise the same dq, dk, dv."""
    fa, q, k, v, do, segments = _flash_case(card, dtype, 128, seg, s=512,
                                            h=8, kvh=2)
    o, lse = fa.flash_forward_kernel(q, k, v, segment_ids=segments)
    first = fa.flash_backward_kernel(q, k, v, o, lse, do,
                                     segment_ids=segments)
    second = fa.flash_backward_kernel(q, k, v, o, lse, do,
                                      segment_ids=segments)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_delta_fault_exceeds_limit(card):
    """The plain dq and dk computed with delta off by a constant fail
    the bf16 gradient limit that the kernels pass (dv takes no delta)."""
    fa, q, k, v, do, _ = _flash_case(card, torch.bfloat16, 128, False,
                                     s=512)
    o, lse = fa.flash_forward_kernel(q, k, v)
    dq, dk, _ = fa.flash_backward_kernel(q, k, v, o, lse, do)
    p, ds, qg, dog = fa._probs(q, k, v, o, lse, do, True, None)
    bad = ds - 1.0 * p
    rdq = fa._dq(ds, q, k)
    rdk, _ = fa._dkv(p, ds, qg, dog, k, v)
    grad_tol = FLASH_TOL[torch.bfloat16][1]
    assert _tile_err(dq, rdq) <= grad_tol and _tile_err(dk, rdk) <= grad_tol
    assert _tile_err(fa._dq(bad, q, k), rdq) > grad_tol
    assert _tile_err(fa._dkv(p, bad, qg, dog, k, v)[0], rdk) > grad_tol


def test_engine_kernel_path_matches_cpu_path(card):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    outs = {}
    for device in ('cuda', 'cpu'):
        engine = ContinuousBatchingEngine('tiny', cfg=cfg, params=params,
                                          device=device, max_slots=2,
                                          max_len=96)
        try:
            outs[device] = [engine.generate_ids(p, max_new_tokens=8)
                            for p in ([3, 1, 4, 1, 5], [2, 7, 18] * 9)]
        finally:
            engine.shutdown()
    assert outs['cuda'] == outs['cpu']


def test_lm_head_fp32_result_on_card(card):
    """bf16 operands with an fp32 result on the card, as on the CPU."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.decode import _lm_head
    cfg = get_model_config('tiny')
    params = llama.init_params(3, cfg, device='cpu',
                               weight_dtype=torch.bfloat16)
    x = torch.randn((2, 3, 64), generator=torch.Generator().manual_seed(4))
    cpu = _lm_head(params, x.bfloat16(), cfg)
    on_card = {k: {n: t.to(card) for n, t in v.items()}
               for k, v in params.items() if k != 'layers'}
    out = _lm_head(on_card, x.bfloat16().to(card), cfg)
    assert out.dtype == torch.float32
    assert (out.cpu() - cpu).abs().max().item() <= 1e-5


def _decode_case(card, cache, q_len, t, lengths, d=128, g=4, kvh=2,
                 poison=False):
    gen = torch.Generator(device=card)
    gen.manual_seed(q_len * 100 + t + d)
    b = len(lengths)
    dtype = torch.float32 if cache == 'fp32' else torch.bfloat16
    k = torch.randn((b, t, kvh, d), generator=gen, device=card)
    v = torch.randn((b, t, kvh, d), generator=gen, device=card)
    q = torch.randn((b, q_len, kvh * g, d), generator=gen,
                    device=card).to(dtype)
    nv = torch.tensor(lengths, dtype=torch.int32, device=card)
    if poison:
        stale = (torch.arange(t, device=card)[None, :] >=
                 nv[:, None])[..., None, None]
        k = torch.where(stale, torch.full_like(k, 1e4), k)
        v = torch.where(stale, torch.full_like(v, -1e4), v)
    if cache == 'int8':
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return q, k, v, nv, ks, vs
    return q, k.to(dtype), v.to(dtype), nv, None, None


def _live_rows(nv, q_len):
    """[B, Q, 1, 1] mask of the query rows that attend at least one row
    (the others are discarded by contract)."""
    limit = (nv.long()[:, None] - (q_len - 1) +
             torch.arange(q_len, device=nv.device)[None, :])
    return (limit > 0)[..., None, None]


DECODE_TOL = {'bf16': 2e-2, 'fp32': 2e-4, 'int8': 2e-2}
# W8A8 prefill logits, card against CPU on their own activation codes,
# relative to the largest logit: 1.8e-7 measured on an H100 (TINY,
# head_dim 128, fp32 compute), every code equal, the scales an ulp apart.
W8A8_TOL = 1e-6


@pytest.mark.parametrize('poison', [False, True], ids=['clean', 'stale'])
@pytest.mark.parametrize('t,lengths', [
    (256, (0, 1, 31, 32, 33, 100, 255, 256)),
    (288, (1, 17, 257, 288)),
    (2048, (1, 15, 16, 17, 1000, 2048, 1000, 2048))],
    ids=['T256', 'T288', 'T2048'])
@pytest.mark.parametrize('q_len', [1, 5])
@pytest.mark.parametrize('cache', ['bf16', 'fp32', 'int8'])
def test_decode_kernel_matches_plain(card, cache, q_len, t, lengths,
                                     poison):
    from skypilot_tpu_torch.ops import decode_attention as da
    q, k, v, nv, ks, vs = _decode_case(card, cache, q_len, t, lengths,
                                       poison=poison)
    name = 'decode_attention_quant' if cache == 'int8' else \
        'decode_attention'
    before = da.LAUNCHES[name]
    out = da.decode_attention(q, k, v, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.LAUNCHES[name] == before + 1
    ref = da.xla_decode_attention(q, k, v, nv, ks, vs)
    keep = _live_rows(nv, q_len)
    assert torch.isfinite(out).all()
    err = ((out.float() - ref.float()).abs() * keep).max().item()
    assert err <= DECODE_TOL[cache]
    # n_valid = 0 gives 0 (acc / max(l, 1e-30) with nothing read).
    empty = (nv == 0).nonzero()
    if len(empty):
        assert out[empty[:, 0]].abs().max().item() == 0


@pytest.mark.parametrize('t,lengths', [
    (64, (1, 33, 63, 64)), (300, (1, 33, 299, 300)),
    (2500, (1, 33, 2047, 2500))], ids=['T64', 'T300', 'T2500'])
@pytest.mark.parametrize('d', [64, 256])
def test_decode_kernel_head_dims_and_splits(card, d, t, lengths):
    """Other head dims, and caches whose split count (_num_splits: 4
    CTAs per (sequence, kv head) here) shares a sequence's 16-row tiles
    unevenly; Q*G = 24 runs on tensor cores at D=64 and on CUDA cores
    at D=256, and Q*G = 40 at D=256, too large for four warps, on a
    one-warp CUDA-core CTA."""
    from skypilot_tpu_torch.ops import decode_attention as da
    q, k, v, nv, _, _ = _decode_case(card, 'bf16', 3, t, lengths, d=d,
                                     g=8)
    out = da.decode_attention(q, k, v, nv)
    ref = da.xla_decode_attention(q, k, v, nv)
    keep = _live_rows(nv, 3)
    assert ((out.float() - ref.float()).abs() * keep).max().item() <= 2e-2
    # bf16, D=256, Q*G = 5 x 8 = 40: too much shared memory for 4 warps.
    big = torch.randn((1, 5, 64, 256), device=card).bfloat16()
    kb = torch.randn((1, 64, 8, 256), device=card).bfloat16()
    nvb = torch.tensor([64], dtype=torch.int32, device=card)
    out = da.decode_attention(big, kb, kb, nvb)
    ref = da.xla_decode_attention(big, kb, kb, nvb)
    keep = _live_rows(nvb, 5)
    assert ((out.float() - ref.float()).abs() * keep).max().item() <= 2e-2


@pytest.mark.parametrize('splits', [1, 2, 3, 4])
@pytest.mark.parametrize('t', [300, 2500])
@pytest.mark.parametrize('d,q_len,g,m_tiles', [
    (64, 1, 4, 1), (64, 5, 8, 0), (128, 4, 8, 2), (128, 5, 8, 0),
    (256, 2, 8, 1), (256, 4, 8, 0), (256, 5, 8, 0)],
    ids=['D64_QG4', 'D64_QG40', 'D128_QG32', 'D128_QG40', 'D256_QG16',
         'D256_QG32', 'D256_QG40'])
@pytest.mark.parametrize('cache', ['bf16', 'fp32', 'int8'])
def test_decode_kernel_paths_and_splits(card, monkeypatch, cache, d, q_len,
                                        g, m_tiles, t, splits):
    """Both kernels of the one-launch design: bf16 queries with Q*G <= 32
    (<= 16 at D=256) on tensor cores, fp32 queries and wider windows on
    CUDA cores; a (sequence, kv head)'s rows over 1 to 4 split CTAs (one
    cluster, merged by rank 0), at T off the 16-row tile. A second call
    is bitwise the same (the merge leaves nothing behind), and n_valid =
    0 gives exactly 0."""
    from skypilot_tpu_torch.ops import decode_attention as da
    lengths = (0, 1, 33, t - 1, t)
    # B * KVH = 10 pairs: a wave of 10 * splits CTAs gives `splits`
    monkeypatch.setattr(da, '_WAVE_CTAS', 10 * splits)
    assert da._num_splits(len(lengths), 2, t) == splits
    q, k, v, nv, ks, vs = _decode_case(card, cache, q_len, t, lengths, d=d,
                                       g=g)
    want = 0 if cache == 'fp32' else m_tiles
    assert da._mma_tiles(q.dtype, k.dtype, q_len * g, d) == want
    name = 'decode_attention_quant' if cache == 'int8' else \
        'decode_attention'
    before = da.LAUNCHES[name]
    out = da.decode_attention(q, k, v, nv, k_scale=ks, v_scale=vs)
    again = da.decode_attention(q, k, v, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.LAUNCHES[name] == before + 2
    assert torch.equal(out, again)
    assert out[0].abs().max().item() == 0
    ref = da.xla_decode_attention(q, k, v, nv, ks, vs)
    assert torch.isfinite(out).all()
    assert _head_err(out, ref, nv) <= DECODE_TOL[cache]


@pytest.mark.parametrize('cache', ['bf16', 'fp32', 'int8'])
def test_decode_kernel_engine_shape(card, cache):
    """The batch engine's decode call at llama3-8b heads (B=4, KVH=8,
    G=4, D=128, T=288 = prompt bucket 256 + 32 new tokens): 4 splits a
    (sequence, kv head), 128 CTAs in one wave; bf16 queries on tensor
    cores."""
    from skypilot_tpu_torch.ops import decode_attention as da
    lengths = (257, 200, 288, 131)
    assert da._num_splits(4, 8, 288) == 4
    q, k, v, nv, ks, vs = _decode_case(card, cache, 1, 288, lengths,
                                       kvh=8)
    assert da._mma_tiles(q.dtype, k.dtype, 4, 128) == (
        0 if cache == 'fp32' else 1)
    name = 'decode_attention_quant' if cache == 'int8' else \
        'decode_attention'
    before = da.LAUNCHES[name]
    out = da.decode_attention(q, k, v, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.LAUNCHES[name] == before + 1
    ref = da.xla_decode_attention(q, k, v, nv, ks, vs)
    assert torch.isfinite(out).all()
    assert _head_err(out, ref, nv) <= DECODE_TOL[cache]


def test_decode_kernel_rejects_unsupported_inputs(card):
    from skypilot_tpu_torch.ops import decode_attention as da
    q, k, v, nv, _, _ = _decode_case(card, 'bf16', 1, 64, (3, 64))
    with pytest.raises(ValueError, match='head dim'):
        da.decode_attention(q[..., :32], k[..., :32].contiguous(),
                            v[..., :32].contiguous(), nv)
    with pytest.raises(ValueError, match='dtype'):
        da.decode_attention(q.half(), k.half(), v.half(), nv)
    with pytest.raises(ValueError, match='contiguous'):
        da.decode_attention_kernel(
            q.reshape(2, 2, 4, 128), k[:, ::2], v[:, ::2], nv, 1)


def test_decode_kernel_asserts_n_valid_past_cache(card):
    """n_valid > T fails the kernel's device-side assert, which ends the
    process's CUDA context: run in a child process."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        'import torch\n'
        'from skypilot_tpu_torch.ops import decode_attention as da\n'
        "q = torch.randn((2, 1, 8, 128), device='cuda').bfloat16()\n"
        "k = torch.randn((2, 64, 2, 128), device='cuda').bfloat16()\n"
        "nv = torch.tensor([3, 65], dtype=torch.int32, device='cuda')\n"
        'da.decode_attention(q, k, k, nv)\n'
        'torch.cuda.synchronize()\n')
    run = subprocess.run([sys.executable, '-c', script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert 'device-side assert' in run.stderr, run.stderr[-2000:]


def test_int8_matmul_on_card_is_exact(card):
    """W8A8 products: torch._int_mm behind padding equals the CPU's
    int32 matmul, for row counts below its minimum and widths off 8."""
    from skypilot_tpu_torch.models.quant import int8_matmul
    gen = torch.Generator().manual_seed(5)
    for m, k, n in ((1, 4096, 1024), (5, 14336, 24), (300, 60, 12)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8)
        got = int8_matmul(a.to(card), b.to(card)).cpu()
        assert torch.equal(got, int8_matmul(a, b))


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['fp', 'int8-kv'])
def test_batch_engine_kernel_path_matches_cpu_path(card, quantize_kv):
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    outs = {}
    for device in ('cuda', 'cpu'):
        engine = InferenceEngine('tiny', cfg=cfg, params=params,
                                 device=device, max_batch=2,
                                 quantize_kv=quantize_kv)
        outs[device] = engine.generate_ids(prompts, max_new_tokens=8)
    assert outs['cuda'] == outs['cpu']


def _record_codes(monkeypatch, log, feed=None):
    """Route W8A8's activation quantization through a recorder: each
    call appends (codes, scale, x / scale) on the CPU to ``log``; with
    ``feed``, a call returns the next fed (codes, scale) instead of its
    own."""
    from skypilot_tpu_torch.models import quant

    def quantize(x, n_contract):
        q, scale = _quantize_activations(x, n_contract)
        log.append((q.cpu(), scale.cpu(), (x.float() / scale).cpu()))
        if feed is not None:
            fed_q, fed_scale, _ = feed.pop(0)
            assert fed_q.shape == q.shape
            return fed_q.to(q.device), fed_scale.to(scale.device)
        return q, scale

    monkeypatch.setattr(quant, '_quantize_activations', quantize)


def _code_witness(card_log, cpu_log):
    """A string of how many codes differ and where the first differs.
    At the first call where any differs, every differing code is one step
    off and the two sides' unrounded values x / scale are within 1e-3 of
    each other: a rounding tie, not a different product."""
    n_diff = n_codes = 0
    first = None
    for i, ((qa, _, va), (qb, _, vb)) in enumerate(zip(card_log, cpu_log)):
        diff = qa != qb
        n_diff += int(diff.sum())
        n_codes += diff.numel()
        if first is None and diff.any():
            steps = (qa.int() - qb.int())[diff].abs()
            gap = (va[diff] - vb[diff]).abs().max().item()
            first = (f'first in call {i} of {len(card_log)}: '
                     f'{int(diff.sum())} codes, x/scale {gap:.2e} apart')
            assert int(steps.max()) == 1
            assert gap <= 1e-3
    return f'{n_diff} of {n_codes} activation codes differ ({first})'


def _w8a8_tiny(card):
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.quant import quantize_params
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    qparams = quantize_params(params)
    on_card = {k: {n: t.to(card) for n, t in v.items()}
               for k, v in qparams.items() if k != 'layers'}
    on_card['layers'] = {k: {n: t.to(card) for n, t in v.items()}
                         for k, v in qparams['layers'].items()}
    return cfg, params, qparams, on_card


def test_w8a8_prefill_on_card_matches_cpu(card, monkeypatch):
    """W8A8 prefill on the card and on the CPU. The int8 products are
    exact on both and the rest of the path is elementwise, so the CPU
    fed the card's activation codes and scales gives the card's logits
    bit for bit; on its own codes and scales (fp32 norms and attention
    summed in another order move a scale by an ulp) they agree within
    W8A8_TOL."""
    from skypilot_tpu_torch.models import decode as decode_lib
    cfg, _, qparams, on_card = _w8a8_tiny(card)
    tokens = torch.randint(0, 512, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    logs = {'cuda': [], 'cpu': [], 'fed': []}
    _record_codes(monkeypatch, logs['cuda'])
    got, _ = decode_lib.prefill(on_card, tokens.to(card), lengths.to(card),
                                cfg, 24)
    got = got.cpu()
    _record_codes(monkeypatch, logs['cpu'])
    cpu, _ = decode_lib.prefill(qparams, tokens, lengths, cfg, 24)
    feed = list(logs['cuda'])
    _record_codes(monkeypatch, logs['fed'], feed)
    cpu_fed, _ = decode_lib.prefill(qparams, tokens, lengths, cfg, 24)
    assert not feed
    rel = ((got - cpu).abs().max() / cpu.abs().max()).item()
    print(f'w8a8 prefill card vs cpu: logits rel {rel:.3e}; fed the '
          f"card's codes equal: {torch.equal(got, cpu_fed)}; "
          f"{_code_witness(logs['cuda'], logs['cpu'])}")
    assert torch.equal(got, cpu_fed)
    assert rel <= W8A8_TOL
    assert torch.equal(got.argmax(-1), cpu.argmax(-1))


def test_w8a8_generate_on_card_parts_only_at_rounding_ties(card,
                                                           monkeypatch):
    """W8A8 greedy generation: fed the card's activation codes and
    scales, the CPU gives the card's tokens; on its own codes the two
    may part, and then only where a code at a rounding tie went the
    other way (``_code_witness``)."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    cfg, params, _, _ = _w8a8_tiny(card)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    logs = {'cuda': [], 'cpu': [], 'fed': []}
    outs = {}
    for device in ('cuda', 'cpu', 'fed'):
        feed = list(logs['cuda']) if device == 'fed' else None
        _record_codes(monkeypatch, logs[device], feed)
        engine = InferenceEngine(
            'tiny', cfg=cfg, params=params, max_batch=4, quantize=True,
            device='cuda' if device == 'cuda' else 'cpu')
        outs[device] = engine.generate_ids(prompts, max_new_tokens=16)
        assert not feed
    witness = _code_witness(logs['cuda'], logs['cpu'])
    print(f"w8a8 generate card vs cpu: tokens equal "
          f"{outs['cuda'] == outs['cpu']}, fed the card's codes "
          f"{outs['cuda'] == outs['fed']}; {witness}")
    assert outs['fed'] == outs['cuda']
    if outs['cpu'] != outs['cuda']:
        assert '(None)' not in witness


# ---------------------------------------------------------------------------
# Speculative verify windows and LoRA pages on the card
# ---------------------------------------------------------------------------

def _verify_case(device, lora):
    """TINY (head_dim 128, fp32 compute): two prompts prefilled into a
    paged pool, then one Q=5 verify window (slot 1 padded to 3 inputs),
    with or without adapter pages (slot 0 on page 1, slot 1 on page 0).
    Returns (verify logits [2, 5, V], paged_attention launches)."""
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.utils.device import to_device
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    # Drawn on the CPU: a generator on the card draws other numbers.
    params = to_device(llama.init_params(7, cfg, device='cpu'),
                       torch.device(device))
    cache = decode_lib.init_paged_cache(cfg, 9, 16, 2, 4, device=device)
    cache.block_tables.copy_(torch.tensor([[3, 1, 0, 0], [2, 4, 0, 0]]))
    lora_args = {}
    if lora:
        pages = lora_lib.init_adapter_pages(cfg, 1, 4, device=device)
        adapter = lora_lib.init_lora_params(5, cfg, 4, device='cpu')
        gen = torch.Generator().manual_seed(6)
        for key in ('wq_b', 'wv_b'):
            adapter[key] = 0.05 * torch.randn(adapter[key].shape,
                                              generator=gen)
        lora_lib.write_adapter_page(pages, 1, adapter)
        lora_args = dict(lora_pages=pages, adapter_ids=torch.tensor(
            [1, 0], dtype=torch.int32, device=device))
    for slot, prompt in enumerate(([3, 1, 4, 1, 5, 9, 2, 6] * 2,
                                   [2, 7, 18, 28])):
        tokens = torch.tensor([prompt], dtype=torch.int32, device=device)
        _, cache = decode_lib.prefill_chunk(
            params, tokens, 0, len(prompt), slot, cache, cfg,
            lora_pages=lora_args.get('lora_pages'),
            adapter_id=(1 - slot) if lora else None)
    window = torch.tensor([[7, 8, 9, 10, 11], [12, 13, 14, 0, 0]],
                          dtype=torch.int32, device=device)
    n_input = torch.tensor([5, 3], dtype=torch.int32, device=device)
    pa.reset_launch_counts()
    logits, _ = decode_lib.paged_verify_step(params, window, cache, cfg,
                                             n_input=n_input, **lora_args)
    return logits.cpu(), pa.LAUNCHES['paged_attention'], cfg.n_layers


@pytest.mark.parametrize('lora', [False, True], ids=['plain', 'lora'])
def test_verify_window_on_card_matches_cpu(card, lora):
    """A Q=5 verify window through the paged kernel (fp32 compute, so
    the kernel's CUDA-core route) against the CPU's plain attention:
    logits of the live rows within 1e-4 absolute; the kernel launched
    once a layer."""
    got, launches, n_layers = _verify_case('cuda', lora)
    want, cpu_launches, _ = _verify_case('cpu', lora)
    assert launches == n_layers and cpu_launches == 0
    live = [(0, j) for j in range(5)] + [(1, j) for j in range(3)]
    for b, j in live:
        assert (got[b, j] - want[b, j]).abs().max().item() <= 1e-4, (b, j)


def test_spec_and_lora_engines_on_card_match_cpu(card):
    """Greedy tokens of a speculative engine (draft_k 4) and of a LoRA
    engine on the card equal the plain engine's on the CPU and the LoRA
    engine's on the CPU (TINY, head_dim 128, fp32 compute)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    adapter = lora_lib.init_lora_params(5, cfg, 4, device='cpu')
    gen = torch.Generator().manual_seed(6)
    for key in ('wq_b', 'wv_b'):
        adapter[key] = 0.05 * torch.randn(adapter[key].shape, generator=gen)
    prompts = [[5, 6, 7, 8] * 3, [(7 * i + 3) % 512 for i in range(21)],
               [9] * 6]
    kw = dict(cfg=cfg, params=params, max_slots=2, max_len=96,
              block_size=8, prefill_chunk=8)

    def run(device, **extra):
        engine = ContinuousBatchingEngine('tiny', device=device, **kw,
                                          **extra)
        try:
            if 'lora_pages' in extra:
                engine.register_adapter('a', adapter)
                return [engine.generate_ids(p, max_new_tokens=16,
                                            adapter='a') for p in prompts]
            return [engine.generate_ids(p, max_new_tokens=16)
                    for p in prompts]
        finally:
            engine.shutdown()

    plain_cpu = run('cpu')
    assert run('cuda', spec_decode=True, draft_k=4) == plain_cpu
    assert run('cuda') == plain_cpu
    lora_cpu = run('cpu', lora_pages=1, lora_max_rank=4)
    assert run('cuda', lora_pages=1, lora_max_rank=4) == lora_cpu
    assert lora_cpu != plain_cpu


# The MoE configs' attention heads: deepseek-moe-16b (16 heads on 16 kv
# heads of 128: G=1) and gpt-oss-20b (64 on 8 of dim 64: G=8).
MOE_HEADS = {'G1_D128': dict(kvh=16, g=1, d=128),
             'G8_D64': dict(kvh=8, g=8, d=64)}


@pytest.mark.parametrize('q_len', [1, 5])
@pytest.mark.parametrize('heads', list(MOE_HEADS))
@pytest.mark.parametrize('quant', [False, True], ids=['bf16', 'int8'])
def test_paged_kernel_moe_heads_match_plain(card, quant, heads, q_len):
    q, k, v, bt, nv, ks, vs = _case(card, torch.bfloat16, quant, q_len,
                                    **MOE_HEADS[heads])
    name = 'paged_attention_quant' if quant else 'paged_attention'
    before = pa.LAUNCHES[name]
    out = pa.paged_attention(q, k, v, bt, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_attention_reference(q, k, v, bt, nv, ks, vs)
    assert torch.isfinite(out).all()
    assert _head_err(out, ref, nv) <= PAGED_TOL[torch.bfloat16]


@pytest.mark.parametrize('q_len', [1, 5])
@pytest.mark.parametrize('cache', ['bf16', 'int8'])
def test_decode_kernel_g1_d128_matches_plain(card, cache, q_len):
    """deepseek-moe-16b's heads (G=1) on the batch engine's kernels."""
    from skypilot_tpu_torch.ops import decode_attention as da
    lengths = (1, 15, 16, 17, 1000, 2048, 1000, 2048)
    q, k, v, nv, ks, vs = _decode_case(card, cache, q_len, 2048, lengths,
                                       d=128, g=1, kvh=16)
    name = 'decode_attention_quant' if cache == 'int8' else \
        'decode_attention'
    before = da.LAUNCHES[name]
    out = da.decode_attention(q, k, v, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert da.LAUNCHES[name] == before + 1
    ref = da.xla_decode_attention(q, k, v, nv, ks, vs)
    keep = _live_rows(nv, q_len)
    assert torch.isfinite(out).all()
    err = ((out.float() - ref.float()).abs() * keep).max().item()
    assert err <= DECODE_TOL[cache]


@pytest.mark.parametrize('dispatch', ['dense', 'capacity'])
def test_moe_engines_on_card_match_cpu(card, dispatch):
    """TINY_MOE with head_dim 128 at fp32 compute: greedy tokens of both
    engines on the card (paged and decode kernels, MoE products on the
    card) equal their CPU runs, under dense dispatch and under capacity
    dispatch at capacity 0.5, where a 64-row prefill chunk drops half
    its assignments and its padding rows claim capacity. Those rows
    read the pool's null row, which every padded write aims at: the
    pool writes leave it the same on both devices. The prefill routes
    of these prompts keep their top-3 order by at least 6.7e-4 (padding
    rows) and 2.0e-3 (real rows) against logit differences of at most
    2.1e-6 between the devices (tools/moe_route_diff.py, seed 7)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny-moe', head_dim=128,
                           compute_dtype=torch.float32,
                           moe_dispatch=dispatch, capacity_factor=0.5)
    params = llama.init_params(7, cfg, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    outs = {}
    for device in ('cuda', 'cpu'):
        engine = ContinuousBatchingEngine('tiny-moe', cfg=cfg,
                                          params=params, device=device,
                                          max_slots=2, max_len=96)
        try:
            outs[device] = [engine.generate_ids(p, max_new_tokens=8)
                            for p in prompts]
        finally:
            engine.shutdown()
        batch = InferenceEngine('tiny-moe', cfg=cfg, params=params,
                                device=device, max_batch=4)
        outs[device].append(batch.generate_ids(prompts, max_new_tokens=8))
    assert outs['cuda'] == outs['cpu']


def test_moe_capacity_drops_on_card_match_cpu(card):
    """The capacity block with drops (capacity 0.25: C = 8 of 64 rows x
    2 choices / 4 experts) on the card against the CPU, fp32, on inputs
    whose every router row keeps its top-2 order by more than 1e-5 (so
    that the k-major claims are the same on both devices): outputs to
    1e-5, and most assignments dropped."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny-moe', compute_dtype=torch.float32,
                           moe_dispatch='capacity', capacity_factor=0.25)
    params = llama.init_params(3, cfg, device='cpu')
    lp = {k: v[0] for k, v in params['layers']['moe'].items()}
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    logits = torch.einsum('bsd,de->bse', x, lp['router'])
    top = torch.sort(logits, dim=-1, descending=True).values
    assert (top[..., :2] - top[..., 1:3]).min().item() > 1e-5
    want, want_aux = llama._moe_block(x, lp, cfg)
    got, got_aux = llama._moe_block(
        x.to(card), {k: v.to(card) for k, v in lp.items()}, cfg)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    assert abs(got_aux.item() - want_aux.item()) <= 1e-6
    dense, _ = llama._moe_block(
        x, lp, get_model_config('tiny-moe', compute_dtype=torch.float32))
    assert (dense - want).abs().max().item() > 1e-2


@pytest.mark.parametrize('dtype', [None, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_checkpoint_loads_on_card_as_on_cpu(card, tmp_path, dtype):
    """A TINY (head_dim 128) HF checkpoint written by the port loads on
    the card bitwise equal to its CPU load."""
    from skypilot_tpu_torch.models import hf_interop, llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128)
    hf_interop.save_checkpoint(llama.init_params(5, cfg, device='cpu'),
                               cfg, str(tmp_path))
    cpu, _ = hf_interop.load_checkpoint(str(tmp_path), dtype=dtype,
                                        device='cpu')
    gpu, gcfg = hf_interop.load_checkpoint(str(tmp_path), dtype=dtype,
                                           device=card)

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, f'{prefix}{key}/')
        else:
            yield prefix, tree

    got = dict(leaves(gpu))
    for key, want in leaves(cpu):
        assert got[key].device.type == 'cuda'
        assert got[key].dtype == want.dtype == (dtype or torch.float32)
        assert torch.equal(got[key].cpu().view(torch.int16)
                           if want.dtype == torch.bfloat16
                           else got[key].cpu(),
                           want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want), key


def test_tokenizer_fixture_holds_on_card_machine(card):
    """On the card machine's Python, the port's tokenizer.json reader
    gives the fixture's recorded ids (those of the ``tokenizers``
    library) and text back. That the port never imports ``tokenizers``
    is what ``test_torch_isolation.py`` holds, with the library blocked;
    this test does not depend on whether the library is installed."""
    import json
    import os
    from skypilot_tpu_torch.inference.tokenizer import HFTokenizer
    fixture = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'skypilot_tpu_torch', 'testdata',
        'tokenizer_llama3')
    tok = HFTokenizer(fixture)
    with open(os.path.join(fixture, 'expected.json'),
              encoding='utf-8') as f:
        expected = json.load(f)
    assert len(expected) >= 20
    for case in expected:
        assert tok.encode(case['text'], add_bos=False) == case['ids']
        assert tok._tok.decode(case['ids']) == case['text']


@pytest.mark.parametrize('quantize_kv', [False, True], ids=['bf16', 'int8'])
def test_kv_block_round_trip_between_card_engines(card, quantize_kv):
    """Pool blocks of a prefill-role engine on the card, read by
    ``_read_block_arrays``, packed, unpacked and written by
    ``_write_block_arrays`` into a decode-role engine's pool at other
    block ids, are bitwise the source blocks (k, v and, for an int8 pool,
    the fp32 row scales); then a full migration through the two engines
    decodes the colocated engine's greedy tokens."""
    from skypilot_tpu_torch.inference import kv_migrate
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128)   # bf16 compute
    params = llama.init_params(3, cfg, device='cuda')
    kw = dict(cfg=cfg, params=params, device='cuda', max_slots=2,
              max_len=96, quantize_kv=quantize_kv)
    pre = ContinuousBatchingEngine('tiny', role='prefill', **kw)
    dec = ContinuousBatchingEngine('tiny', role='decode', **kw)
    colo = ContinuousBatchingEngine('tiny', **kw)
    try:
        prompt = [(11 * i + 5) % 512 for i in range(40)]
        rid = pre.prefill_and_export(prompt)
        fields = pre._pool_fields()
        assert (set(fields) == {'k', 'v', 'k_scale', 'v_scale'}) == \
            quantize_kv
        assert fields['k'].dtype == (torch.int8 if quantize_kv
                                     else torch.bfloat16)
        src, dst = [1, 2, 3], [7, 5, 9]
        host = pre._read_block_arrays(src)
        payloads = [kv_migrate.pack_arrays(arrays) for arrays in host]
        dec._write_block_arrays(
            [(block, kv_migrate.unpack_arrays(payload))
             for block, payload in zip(dst, payloads)])
        torch.cuda.synchronize()
        for name, pool in fields.items():
            got = dec._pool_fields()[name][:, dst]
            want = pool[:, src]
            assert got.dtype == want.dtype
            assert torch.equal(got.contiguous().view(torch.uint8),
                               want.contiguous().view(torch.uint8)), name
        # The blocks written above are not in dec's pool bookkeeping:
        # clear them before the real migration.
        for pool in dec._pool_fields().values():
            pool[:, dst] = 0
        pulled = kv_migrate.KvPuller(
            kv_migrate.LocalKvSource(pre.exporter),
            sleep=lambda _s: None).pull(
                rid, resident_digests=dec.probe_resident(prompt))
        kernel = 'paged_attention_quant' if quantize_kv else \
            'paged_attention'
        before = pa.LAUNCHES[kernel]
        request = dec.submit_migrated(prompt, pulled, max_new_tokens=8)
        tokens = list(dec.tail_tokens(request))
        after = pa.LAUNCHES[kernel]
        assert tokens == colo.generate_ids(prompt, max_new_tokens=8)
        stats = dec.stats()
        assert stats['kv_imports'] == 1 and stats['kv_import_fallbacks'] == 0
        assert stats['prefill_chunks'] == 0
        assert after - before == cfg.n_layers * stats['decode_steps']
    finally:
        for engine in (pre, dec, colo):
            engine.shutdown()


def test_full_refresh_on_card_equals_serving_params(card):
    """A full live refresh of a bf16 engine on the card from an fp32
    learner tree: every leaf is ``serving_params`` of that tree (bf16
    rounding, norm scales fp32), bit for bit, and the engine serves it."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, flatten_param_paths)
    from skypilot_tpu_torch.models import decode, llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128)
    params = llama.init_params(3, cfg, device=card)          # fp32
    engine = ContinuousBatchingEngine(cfg=cfg, device=card, seed=9,
                                      max_slots=2, max_len=64)
    try:
        assert engine.refresh_weights(params=params, version=2) == 2
        with torch.no_grad():
            want = flatten_param_paths(decode.serving_params(params, cfg))
        for path, leaf in flatten_param_paths(engine.params).items():
            assert leaf.dtype == want[path].dtype, path
            assert torch.equal(leaf, want[path]), path
        # Device time of TINY's copies (microseconds): read unrounded,
        # as stats() rounds to 1e-4 s.
        assert engine._refresh_seconds_total > 0
        assert len(engine.generate_ids([5, 6, 7], max_new_tokens=4)) == 4
    finally:
        engine.shutdown()


def test_grpo_step_flash_launches_at_s128(card):
    """One GRPO learner step on TINY with head_dim 128 at S = 65 + 64 - 1
    = 128: the flash kernels run (1 forward, 1 dq, 1 dk/dv a layer
    without remat; 2 forwards under full remat) and nothing leaves
    their gate."""
    import numpy as np
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import grpo
    rng = np.random.default_rng(0)
    prompts = np.repeat(rng.integers(3, 512, (2, 65)), 4, axis=0)
    generated = rng.integers(0, 512, (8, 64))
    rewards = rng.random(8).astype(np.float32)
    for remat, fwd in (('none', 1), ('full', 2)):
        cfg = get_model_config('tiny', head_dim=128, remat_policy=remat)
        learner = grpo.GrpoLearner(cfg, device=card)
        fa.reset_launch_counts()
        out = learner.learn_rollouts(prompts, generated, rewards, 4)
        torch.cuda.synchronize()
        n = cfg.n_layers
        assert fa.LAUNCHES == {'flash_fwd': fwd * n, 'flash_fwd_seg': 0,
                               'flash_dq': n, 'flash_dq_seg': 0,
                               'flash_dkv': n, 'flash_dkv_seg': 0}
        assert fa.FALLBACKS['cuda'] == 0
        assert np.isfinite(out['loss']) and learner.version == 1


def test_paged_kernel_grpo_heads_match_plain(card):
    """bench-1b7's heads (H=20 on 4 kv heads: G=5, a group that is not a
    power of two) at the GRPO rollout engine's shape: 8 slots of 9
    blocks holding 65 to 129 rows, bf16, Q=1."""
    q, k, v, bt, nv, ks, vs = _case(
        card, torch.bfloat16, False, 1, d=128, g=5, kvh=4, bps=9,
        lengths=(65, 72, 81, 96, 100, 113, 120, 129))
    before = pa.LAUNCHES['paged_attention']
    out = pa.paged_attention(q, k, v, bt, nv)
    torch.cuda.synchronize()
    assert pa.LAUNCHES['paged_attention'] == before + 1
    ref = pa.paged_attention_reference(q, k, v, bt, nv)
    assert torch.isfinite(out).all()
    assert _head_err(out, ref, nv) <= PAGED_TOL[torch.bfloat16]


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.detach().to(device) for k, v in tree.items()}


def test_grpo_gradients_on_card_match_cpu(card):
    """The GRPO loss and every gradient of one learner batch at S=128
    (TINY, head_dim 128, fp32 compute) through the flash kernels on the
    card, against the same params and batch on the CPU (plain
    attention): loss and mean log-prob within 1e-5 of the mean
    log-prob's size, each gradient within 1e-4 of its largest entry
    (the fp32 flash kernels' own limit)."""
    import numpy as np
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import grpo
    from skypilot_tpu_torch.train.step import _leaves, _trainable
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = np.repeat(rng.integers(3, 512, (2, 65)), 4, axis=0)
    tokens = torch.from_numpy(np.concatenate(
        [prompts, rng.integers(0, 512, (8, 64))], axis=1)).int()
    gen_mask = torch.cat([torch.zeros(8, 65, dtype=torch.int32),
                          torch.ones(8, 64, dtype=torch.int32)], dim=1)
    advantages = grpo.grpo_advantages(
        torch.from_numpy(rng.random(8).astype(np.float32)), 4)
    params = llama.init_params(3, cfg, device='cpu')
    got = {}
    for dev in (torch.device('cpu'), card):
        tree = _trainable(_tree_to(params, dev))
        fa.reset_launch_counts()
        loss, mean_lp = grpo.grpo_loss(tree, tokens.to(dev),
                                       gen_mask.to(dev),
                                       advantages.to(dev), cfg)
        grads = torch.autograd.grad(loss, _leaves(tree))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            n = cfg.n_layers
            assert fa.LAUNCHES == {'flash_fwd': n, 'flash_fwd_seg': 0,
                                   'flash_dq': n, 'flash_dq_seg': 0,
                                   'flash_dkv': n, 'flash_dkv_seg': 0}
            assert fa.FALLBACKS['cuda'] == 0
        got[dev.type] = (loss.item(), mean_lp.item(),
                         [g.detach().cpu() for g in grads])
    (loss, mean_lp, grads), (ref_loss, ref_lp, ref_grads) = (
        got['cuda'], got['cpu'])
    scale = abs(ref_lp)
    assert abs(loss - ref_loss) <= 1e-5 * scale
    assert abs(mean_lp - ref_lp) <= 1e-5 * scale
    errs = [((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
            for g, r in zip(grads, ref_grads)]
    print(f'loss {loss} vs {ref_loss}, mean log-prob {mean_lp} vs '
          f'{ref_lp}, gradient errors {errs}')
    assert all(np.isfinite(errs)) and max(errs) <= 1e-4


def test_tp_engines_on_card_match_one_rank(card):
    """Two ranks on the card (gloo) under ``mesh='tensor=2'``: gloo
    takes the CUDA collectives the step uses, and both engines' greedy
    tokens at TINY (head_dim 128, fp32 compute) equal one rank's, each
    rank launching the paged and decode kernels on its shard."""
    import importlib
    import os
    import sys
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.parallel.launch import launch
    # The ranks import the probe by name: its directory goes on the
    # path they inherit.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    probe = importlib.import_module('tp_probe')
    _build.build_all()
    ranks = launch(probe.rank_main, 2, device='cuda')
    single = probe._engines(torch, None)
    for r in ranks:
        assert all(v is True for v in r['collectives'].values()), r
        assert r['backend'] == 'gloo'
        assert r['tp']['launches']['paged_attention'] > 0
        assert r['tp']['launches']['decode_attention'] > 0
    for name in ('batch', 'continuous'):
        assert ranks[0]['tp'][name] == single[name]
