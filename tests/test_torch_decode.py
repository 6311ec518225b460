"""Port paged decode against the JAX reference, on the TINY config.

JAX parameters from ``llama.init_params`` are carried over through
``models/convert.py``; both sides run with fp32 compute. One slot
prefills a prompt chunk, decodes four steps, then runs a Q=3 verify
window (one slot padded by ``n_input``, one slot inactive): logits
agree to 1e-4 and the pool contents to 1e-5 (fp) or exactly (int8, up
to the +-1 of a rounding tie).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

SLOTS, BS, BPS, CHUNK = 3, 8, 6, 16


def _configs(quantized):
    jcfg = jconfig.get_model_config('tiny', compute_dtype=jnp.float32)
    tcfg = tconfig.get_model_config('tiny', compute_dtype=torch.float32)
    if quantized:
        jcfg = jconfig.with_int8_kv_cache(jcfg)
        tcfg = tconfig.with_int8_kv_cache(tcfg)
    return jcfg, tcfg


def _tables():
    perm = np.random.RandomState(0).permutation(
        np.arange(1, SLOTS * BPS + 1))
    return perm.reshape(SLOTS, BPS).astype(np.int32)


def _caches(jcfg, tcfg):
    tables = _tables()
    jc = jdecode.init_paged_cache(jcfg, SLOTS * BPS + 1, BS, SLOTS, BPS)
    jc = dataclasses.replace(jc, block_tables=jnp.asarray(tables))
    tc = tdecode.init_paged_cache(tcfg, SLOTS * BPS + 1, BS, SLOTS, BPS,
                                  device='cpu')
    tc = dataclasses.replace(tc, block_tables=torch.from_numpy(tables))
    return jc, tc


def _assert_pools_match(jc, tc, quantized):
    # Block 0 is the null block: masked writes may race there.
    if quantized:
        diff = np.abs(np.asarray(jc.k[:, 1:], np.int32) -
                      tc.k[:, 1:].numpy().astype(np.int32))
        assert diff.max() <= 1
        diff = np.abs(np.asarray(jc.v[:, 1:], np.int32) -
                      tc.v[:, 1:].numpy().astype(np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(tc.k_scale[:, 1:].numpy(),
                                   np.asarray(jc.k_scale[:, 1:]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tc.v_scale[:, 1:].numpy(),
                                   np.asarray(jc.v_scale[:, 1:]),
                                   rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(tc.k[:, 1:].numpy(),
                                   np.asarray(jc.k[:, 1:]), atol=1e-5)
        np.testing.assert_allclose(tc.v[:, 1:].numpy(),
                                   np.asarray(jc.v[:, 1:]), atol=1e-5)
    np.testing.assert_array_equal(tc.lengths.numpy(),
                                  np.asarray(jc.lengths))


@pytest.mark.parametrize('quantized', [False, True], ids=['fp', 'int8'])
def test_prefill_decode_verify_match_reference(quantized):
    jcfg, tcfg = _configs(quantized)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device='cpu')
    jc, tc = _caches(jcfg, tcfg)
    prompt = [(5 * i + 2) % 512 for i in range(11)]
    buf = np.zeros((1, CHUNK), np.int32)
    buf[0, :len(prompt)] = prompt
    # Prefill slot 1 with the prompt and slot 2 with its first 5 tokens.
    for slot, n in ((1, len(prompt)), (2, 5)):
        jl, jc = jdecode.prefill_chunk(
            jparams, jnp.asarray(buf), jnp.int32(0), jnp.int32(n),
            jnp.int32(slot), jc, jcfg)
        tl, tc = tdecode.prefill_chunk(
            tparams, torch.from_numpy(buf), 0, n, slot, tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_pools_match(jc, tc, quantized)
    active = np.asarray([False, True, True])
    for tok in (17, 403, 88, 251):
        tokens = np.asarray([0, tok, (tok * 7) % 512], np.int32)
        jl, jc = jdecode.paged_decode_step(
            jparams, jnp.asarray(tokens), jc, jcfg,
            active=jnp.asarray(active))
        tl, tc = tdecode.paged_decode_step(
            tparams, torch.from_numpy(tokens), tc, tcfg,
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl[1:].numpy(), np.asarray(jl[1:]),
                                   atol=1e-4)
    _assert_pools_match(jc, tc, quantized)
    window = np.asarray([[0, 0, 0], [44, 317, 0], [5, 6, 7]], np.int32)
    n_input = np.asarray([3, 2, 3], np.int32)
    jl, jc = jdecode.paged_verify_step(
        jparams, jnp.asarray(window), jc, jcfg, active=jnp.asarray(active),
        n_input=jnp.asarray(n_input))
    tl, tc = tdecode.paged_verify_step(
        tparams, torch.from_numpy(window), tc, tcfg,
        active=torch.from_numpy(active), n_input=torch.from_numpy(n_input))
    np.testing.assert_allclose(tl[1, :2].numpy(), np.asarray(jl[1, :2]),
                               atol=1e-4)
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), atol=1e-4)
    assert np.isfinite(tl.numpy()).all()
    _assert_pools_match(jc, tc, quantized)


@pytest.mark.parametrize('quantized', [False, True], ids=['fp', 'int8'])
def test_multi_chunk_prefill_equals_whole_prompt(quantized):
    _, tcfg = _configs(quantized)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(
            jax.random.key(1), _configs(quantized)[0])), tcfg, device='cpu')
    prompt = [(3 * i + 1) % 512 for i in range(37)]
    _, whole = _caches(*_configs(quantized))
    buf = np.zeros((1, 48), np.int32)
    buf[0, :len(prompt)] = prompt
    last_whole, whole = tdecode.prefill_chunk(
        tparams, torch.from_numpy(buf), 0, len(prompt), 0, whole, tcfg)
    _, chunked = _caches(*_configs(quantized))
    for start in range(0, len(prompt), 16):
        piece = prompt[start:start + 16]
        buf = np.zeros((1, 16), np.int32)
        buf[0, :len(piece)] = piece
        last, chunked = tdecode.prefill_chunk(
            tparams, torch.from_numpy(buf), start, len(piece), 0, chunked,
            tcfg)
    np.testing.assert_allclose(last.numpy(), last_whole.numpy(), atol=1e-4)
    assert int(chunked.lengths[0]) == len(prompt)
    if quantized:
        diff = (chunked.k[:, 1:].int() - whole.k[:, 1:].int()).abs()
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(chunked.k[:, 1:].numpy(),
                                   whole.k[:, 1:].numpy(), atol=1e-5)
        np.testing.assert_allclose(chunked.v[:, 1:].numpy(),
                                   whole.v[:, 1:].numpy(), atol=1e-5)


def test_lm_head_keeps_an_fp32_result_in_bf16():
    """bf16 operands, fp32 result: the logits are not rounded to bf16
    (the reference's preferred_element_type=float32)."""
    jcfg = jconfig.get_model_config('tiny')
    tcfg = tconfig.get_model_config('tiny')
    assert tcfg.compute_dtype == torch.bfloat16
    jparams = jllama.init_params(jax.random.key(2), jcfg)
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device='cpu')
    x = np.random.RandomState(3).randn(2, 3, 64).astype(np.float32)
    ref = jdecode._lm_head(jparams, jnp.asarray(x, jnp.bfloat16), jcfg)
    out = tdecode._lm_head(tparams, torch.from_numpy(x).bfloat16(), tcfg)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # A bf16-rounded product would be off by up to half a bf16 ulp.
    rounded = out.bfloat16().float().numpy()
    assert np.abs(rounded - np.asarray(ref)).max() > 1e-4
