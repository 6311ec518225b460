"""Port kernels on the card: the Hopper paged-attention kernels against
their plain PyTorch versions, and the engine's kernel path against its
CPU path.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip.
Run them on the card with::

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import pytest
import torch

from skypilot_tpu_torch.models.decode import quantize_kv
from skypilot_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

# bf16 outputs round at 2^-8 relative; fp32 sums differ in order only.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


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
    """The wrapper's split count (8 = BPS here), one CTA per (sequence,
    kv head), and three, which share a slot's blocks unevenly."""
    if splits is not None:
        monkeypatch.setattr(pa, '_SPLITS', splits)
    q, k, v, bt, nv, ks, vs = _case(card, dtype, quant, q_len, d=d)
    name = 'paged_attention_quant' if quant else 'paged_attention'
    before = pa.LAUNCHES[name]
    out = pa.paged_attention(q, k, v, bt, nv, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES[name] == before + 1
    ref = pa.paged_attention_reference(q, k, v, bt, nv, ks, vs)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


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
