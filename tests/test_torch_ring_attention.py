"""Sequence-parallel attention against the JAX reference, on the CPU: the
twins of ``tests/test_ring_attention.py`` and of
``tests/test_attention_mesh.py::test_pallas_falls_back_under_seq_mesh``.

The port's ranks (gloo, ``tests/torch_seq_ranks.py``) each hold their
block of the columns (over ``seq``) and rows (over ``data``) and run
``multi_head_attention`` with ``parallel=`` (the flash kernels' plain
versions on the CPU); the blocks put back together equal the JAX
package's ``ring_attention`` / ``ulysses_attention`` on the 8 virtual
CPU devices and its ``xla_attention`` on the whole arrays, outputs within
2e-5 and gradients of sum(out^2) within 5e-4 (the reference tests'
limits): ring at seq 2 and 4, causal and full; Ulysses at seq 4, with
kv heads that 4 divides and that it does not; segment ids with a
document boundary on a block boundary (a block whose rows lose every
key of an earlier block); ``impl='pallas'`` at ``data=2,seq=4`` (the
ring) against ``xla_attention``. A ring whose hop does not rotate must
miss the reference. Also: the collectives over ``seq``, the reference's
errors, and the plain flash versions with key segment ids apart from the
query's against a masked einsum. Each mesh launches once.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.attention import xla_attention
from skypilot_tpu.ops.ring_attention import ring_attention, ulysses_attention
from skypilot_tpu.parallel.mesh import MeshConfig, build_mesh
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops import ring_attention as tra
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_seq_ranks as ranks

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
# The reference tests' shapes; the kernel-shaped ones for 'pallas'.
SMALL = dict(b=2, s=64, h=8, kv=4, d=16)
KERNEL = dict(b=4, s=256, h=4, kv=2, d=128)


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32))


def _segments(b, s):
    """Row 0: two documents cut at s / 2, a block boundary at seq 2 and
    4 (every query of the second half loses every key of the first);
    the other rows cut off the block grid."""
    rows = [[0] * (s // 2) + [1] * (s - s // 2)]
    for i in range(1, b):
        cut = s // 4 + (s // 8) * i + 3
        rows.append([0] * cut + [1] * (s - cut))
    return np.asarray(rows, np.int32)


def _jax_mesh(seq):
    return build_mesh(MeshConfig(data=8 // seq, fsdp=1, seq=seq))


def _jax(fn_name, seq, causal, q, k, v, seg, grad=True):
    """The reference's output and (``grad``) gradients of sum(out^2), in
    one compiled program."""
    fn = {'ring': ring_attention, 'ulysses': ulysses_attention,
          'xla': None}[fn_name]
    mesh = _jax_mesh(seq)
    segj = None if seg is None else jnp.asarray(seg)

    def out(q_, k_, v_):
        if fn is None:
            return xla_attention(q_, k_, v_, causal=causal,
                                 segment_ids=segj)
        return fn(q_, k_, v_, causal=causal, segment_ids=segj, mesh=mesh)

    def out_and_grads(q_, k_, v_):
        o, vjp = jax.vjp(out, q_, k_, v_)
        return o, vjp(2 * o)   # d sum(o^2) / do = 2 o

    args = [jnp.asarray(x) for x in (q, k, v)]
    with jax.set_mesh(mesh):
        if not grad:
            return np.asarray(jax.jit(out)(*args)), None
        o, grads = jax.jit(out_and_grads)(*args)
    return np.asarray(o), [np.asarray(g) for g in grads]


# name -> (mesh spec, impl, causal, shape, seed, segments, gradients,
# reference)
CASES = {
    'ring2_causal': ('seq=2', 'ring', True, SMALL, 0, False, True, 'ring'),
    'ring2_full': ('seq=2', 'ring', False, SMALL, 1, False, True, 'ring'),
    'ring2_seg': ('seq=2', 'ring', True, SMALL, 2, True, True, 'ring'),
    'ring4_causal': ('data=2,seq=4', 'ring', True, SMALL, 0, False, True,
                     'ring'),
    'ring4_full': ('data=2,seq=4', 'ring', False, SMALL, 1, False, False,
                   'ring'),
    'ring4_seg': ('data=2,seq=4', 'ring', True, SMALL, 2, True, True,
                  'ring'),
    'ulysses4': ('data=2,seq=4', 'ulysses', True, SMALL, 3, False, True,
                 'ulysses'),
    'ulysses4_full': ('data=2,seq=4', 'ulysses', False, SMALL, 4, False,
                      False, 'ulysses'),
    'ulysses4_kv2': ('data=2,seq=4', 'ulysses', True,
                     dict(SMALL, kv=2), 5, False, True, 'ulysses'),
    'ulysses4_seg': ('data=2,seq=4', 'ulysses', True, SMALL, 6, True, False,
                     'ulysses'),
    'pallas4': ('data=2,seq=4', 'pallas', True, KERNEL, 4, False, False,
                'xla'),
    'pallas4_seg': ('data=2,seq=4', 'pallas', True, KERNEL, 7, True, False,
                    'xla'),
}
MESHES = ('seq=2', 'data=2,seq=4')


def _inputs(name):
    _, _, _, shape, seed, seg, _, _ = CASES[name]
    q, k, v = _qkv(seed=seed, **shape)
    return q, k, v, (_segments(shape['b'], shape['s']) if seg else None)


@pytest.fixture(scope='module')
def launches():
    """Each mesh's one launch, made at its first use."""
    return {}


def _mesh_run(launches, spec):
    if spec not in launches:
        cases = []
        for name, (mspec, impl, causal, *_, grad, _) in CASES.items():
            if mspec == spec:
                q, k, v, seg = _inputs(name)
                cases.append((name, impl, causal, q, k, v, seg, grad))
        n = 2 if spec == 'seq=2' else 8
        planted = _inputs('ring2_causal')[:3] if spec == 'seq=2' else None
        launches[spec] = launch(ranks.attention_checks, n, spec, cases,
                                planted, device='cpu')
    return launches[spec]


def _whole(out, name, key, index=None):
    """The ranks' blocks of one output put back together: rows over
    data, columns over seq."""
    rows = {}
    for r in out:
        x = r['cases'][name][key]
        x = x if index is None else x[index]
        rows.setdefault(r['rows'], {})[r['seq_rank']] = x
    return np.concatenate([np.concatenate([cols[j] for j in sorted(cols)],
                                          axis=1)
                           for _, cols in sorted(rows.items())], axis=0)


@pytest.mark.parametrize('name', list(CASES))
def test_matches_jax(launches, name):
    spec, _, causal, _, _, _, grad, ref_name = CASES[name]
    q, k, v, seg = _inputs(name)
    out = _mesh_run(launches, spec)
    seq = 2 if spec == 'seq=2' else 4
    want, want_grads = _jax(ref_name, seq, causal, q, k, v, seg, grad)
    np.testing.assert_allclose(_whole(out, name, 'out'), want,
                               atol=FWD_TOL, rtol=FWD_TOL)
    if ref_name != 'xla':
        # The reference's ring and Ulysses are its XLA attention too.
        plain, _ = _jax('xla', seq, causal, q, k, v, seg, grad=False)
        np.testing.assert_allclose(_whole(out, name, 'out'), plain,
                                   atol=FWD_TOL, rtol=FWD_TOL)
    if grad:
        for i, g in enumerate(want_grads):
            np.testing.assert_allclose(_whole(out, name, 'grads', i), g,
                                       atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ring_blocks_stay_on_the_plain_kernels(launches):
    """On the CPU every ring block runs the kernels' plain versions: no
    call counts as a fallback."""
    out = _mesh_run(launches, 'seq=2')
    assert all(r['fallbacks'] == {'cuda': 0, 'cpu': 0} for r in out)


def test_planted_ring_fault_misses_the_reference(launches):
    """A ring hop that does not rotate leaves each rank on its own K/V
    block: the output must miss the reference by far more than the
    limit."""
    q, k, v, _ = _inputs('ring2_causal')
    out = _mesh_run(launches, 'seq=2')
    got = np.concatenate([r['planted'] for r in
                          sorted(out, key=lambda r: r['seq_rank'])], axis=1)
    want, _ = _jax('xla', 2, True, q, k, v, None, grad=False)
    assert np.abs(got - want).max() > 100 * FWD_TOL


@pytest.mark.parametrize('spec', MESHES)
def test_seq_collectives(launches, spec):
    """``ring_shift`` hands each rank its predecessor's tensors (fp32 and
    int32), ``all_to_all`` is the reference's tiled all-to-all, and
    ``token_sum`` and the ``replicas`` sum add over every rank holding
    other tokens (data x seq)."""
    out = _mesh_run(launches, spec)
    by_place = {(r['rows'], r['seq_rank']): r['rank'] for r in out}
    n = max(r['seq_rank'] for r in out) + 1

    def x(rank):
        return np.arange(24, dtype=np.float32).reshape(2, 3, 4) + 100 * rank

    for r in out:
        c, i = r['collectives'], r['seq_rank']
        prev = by_place[(r['rows'], (i - 1) % n)]
        np.testing.assert_array_equal(c['shifted'][0], x(prev))
        np.testing.assert_array_equal(
            c['shifted'][1], np.arange(6).reshape(2, 3) + 100 * prev)
        peers = [x(by_place[(r['rows'], j)]) for j in range(n)]
        want = np.concatenate([p[:, :, i * 4 // n:(i + 1) * 4 // n]
                               for p in peers], axis=1)
        np.testing.assert_array_equal(c['a2a'], want)
        assert c['token_sum'] == sum(range(1, len(out) + 1))
        # No fsdp axis: the replicas of a leaf's block are every rank.
        assert c['replicas_sum'] == c['token_sum']


def test_rank_lines_over_several_axes():
    """``Mesh.lines_over`` (the members of ``group_over``'s groups, the
    ``tokens`` and ``replicas`` sums): the ranks that differ only along
    the named axes, at data=2,fsdp=2,seq=2 (rank = 4 data + 2 fsdp +
    seq)."""
    from skypilot_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(np.arange(8).reshape(2, 1, 2, 2, 1, 1), device_type='cpu')
    assert mesh.lines_over(('data', 'seq')) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert mesh.lines_over(('data', 'fsdp', 'seq')) == [list(range(8))]
    assert mesh.lines_over(('fsdp',)) == [[0, 2], [1, 3], [4, 6], [5, 7]]


def test_reference_errors_and_degenerate_meshes():
    """The reference's ValueErrors (a sequence that seq does not divide,
    heads that it does not divide for Ulysses); with no mesh both paths
    are the flash attention, as the reference's are its XLA attention."""
    par = types.SimpleNamespace(seq=8, seq_rank=0)
    with pytest.raises(ValueError, match='not divisible'):
        tra.seq_shard(torch.zeros(2, 36), par)
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 64, 6, 2, 16, 0))
    with pytest.raises(ValueError, match='heads not divisible'):
        tra.ulysses_attention(q, k, v,
                              parallel=types.SimpleNamespace(seq=4))
    flash = tfa.flash_attention(q, k, v, causal=True)
    for fn in (tra.ring_attention, tra.ulysses_attention):
        assert torch.equal(fn(q, k, v, causal=True), flash)
        assert torch.equal(fn(q, k, v, causal=True,
                              parallel=types.SimpleNamespace(seq=1)), flash)


def _masked_einsum(q, k, v, causal, seg, kv_seg):
    """softmax(q k^T / sqrt(d), masked with the finite NEG_INF) v in
    fp32 over the GQA broadcast, the key rows' ids apart."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    sc = torch.einsum('bqhd,bkhd->bhqk', q, kr) / d ** 0.5
    mask = (seg[:, :, None] == kv_seg[:, None, :])[:, None]
    if causal:
        mask = mask & torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.where(mask, sc, -1e30)
    return torch.einsum('bhqk,bkhd->bqhd', torch.softmax(sc, -1), vr)


@pytest.mark.parametrize('causal', [True, False])
def test_plain_flash_with_key_segments(causal):
    """The plain versions of the flash kernels with ``kv_segment_ids``
    apart from ``segment_ids``: the forward against a masked einsum
    (rows that lose every key too: the mean of v, an lse of about
    NEG_INF), the backward against the einsum's gradients where every
    row keeps a key."""
    b, s, h, kv, d = 2, 64, 4, 2, 16
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, s, h, kv, d, 9))
    seg = torch.from_numpy(_segments(b, s))
    # Another block's ids: row 0's first document has no key there.
    kv_seg = torch.flip(seg, [1]).contiguous()
    kv_seg[0] = 1
    o, lse = tfa.flash_forward_reference(q, k, v, causal=causal,
                                         segment_ids=seg,
                                         kv_segment_ids=kv_seg)
    want = _masked_einsum(q, k, v, causal, seg, kv_seg)
    np.testing.assert_allclose(o.numpy(), want.numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    keep = (seg[:, :, None] == kv_seg[:, None, :])
    if causal:
        keep = keep & torch.ones(s, s, dtype=torch.bool).tril()
    empty = ~keep.any(-1)                                   # [B, S]
    assert bool(empty.any()) and bool((~empty).any())
    assert bool((lse.transpose(1, 2)[empty] < -1e29).all())
    assert bool(torch.isfinite(lse).all())
    # Gradients: key ids that leave every row a key (every third key
    # moved to a document no query has, each document's first kept).
    kv_seg = seg.clone()
    kv_seg[:, 1::3] = 99
    starts = torch.ones_like(seg, dtype=torch.bool)
    starts[:, 1:] = seg[:, 1:] != seg[:, :-1]
    kv_seg[starts] = seg[starts]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = _masked_einsum(*leaves, causal, seg, kv_seg)
    do = torch.from_numpy(np.random.RandomState(3).randn(b, s, h, d)
                          .astype(np.float32))
    (want * do).sum().backward()
    o, lse = tfa.flash_forward_reference(q, k, v, causal=causal,
                                         segment_ids=seg,
                                         kv_segment_ids=kv_seg)
    np.testing.assert_allclose(o.numpy(), want.detach().numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL)
    got = tfa.flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                       segment_ids=seg,
                                       kv_segment_ids=kv_seg)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
