"""The bench twin (``skypilot_tpu_torch/bench.py``) on the CPU.

``python -m skypilot_tpu_torch.bench --device cpu`` prints one JSON line
in each mode with the reference's keys (``bench.py``: the top-level
metric/value/unit/vs_baseline/detail, and the detail keys of its train,
decode and kernels lines) plus the card's name and power limit; the
kernels mode passes on the plain versions; without a card and without
``--device cpu`` it prints the reference's unavailable line and exits 1;
the peak comes from the card's name.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from skypilot_tpu_torch import bench
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'detail'}
# The detail keys of the reference's lines (its bench.py:127-135 decode,
# :282 kernels, :430-437 train).
DETAIL_KEYS = {
    'train': {'tokens_per_sec_per_chip', 'achieved_tflops_per_chip',
              'peak_tflops_per_chip', 'batch', 'seq', 'steps', 'loss',
              'peak_estimated'},
    'decode': {'batch', 'prompt_len', 'new_tokens', 'quantized',
               'attention_impl', 'param_dtype', 'devices_used',
               'per_seq_toks_per_sec', 'prefill_plus_n_seconds'},
    'kernels': {'interpret_mode', 'flash_fwd', 'flash_seg_fwd', 'flash_dq',
                'flash_dk', 'flash_dv', 'flash_seg_dq', 'flash_seg_dk',
                'flash_seg_dv', 'decode_kernel', 'decode_kernel_int8kv',
                'paged_kernel', 'paged_kernel_int8kv',
                'paged_verify_kernel'},
}
METRICS = {'train': 'train_mfu_tiny_cpu1',
           'decode': 'decode_toks_per_sec_tiny_cpu1',
           'kernels': 'hand_kernels_vs_plain_cpu'}


@pytest.mark.parametrize('mode', ['train', 'decode', 'kernels'])
def test_cpu_modes_print_the_reference_keys(mode):
    steps = [] if mode == 'kernels' else ['--steps', '4']
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.bench', '--device',
         'cpu', '--mode', mode] + steps,
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == TOP_KEYS
    assert line['metric'] == METRICS[mode]
    detail = line['detail']
    assert DETAIL_KEYS[mode] <= set(detail)
    assert detail['card'] == 'cpu' and detail['power_limit_w'] is None
    if mode == 'train':
        assert detail['batch'] == 4 and detail['seq'] == 64
        assert detail['optimizer'] == 'adamw' and line['value'] > 0
    elif mode == 'decode':
        assert detail['new_tokens'] == 4 and line['value'] > 0
    else:
        assert line['value'] == 1 and detail['interpret_mode'] is True


def test_train_defaults_follow_the_reference():
    """On the card: bench-1b7 with Adafactor, bf16 params, the config's
    full remat, B=8, S=2048; on the CPU: TINY's AdamW, fp32, B=4, S=64;
    flags override each."""
    args = bench._parser().parse_args([])
    cfg, optimizer, batch, seq = bench.train_setup(args, 'bench-1b7', True)
    assert (optimizer, cfg.param_dtype, cfg.remat_policy, batch, seq) == \
        ('adafactor', torch.bfloat16, 'full', 8, 2048)
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (2560, 22, 20, 4, 6912, 32000)
    cfg, optimizer, batch, seq = bench.train_setup(args, 'tiny', False)
    assert (optimizer, cfg.param_dtype, batch, seq) == \
        ('adamw', torch.float32, 4, 64)
    args = bench._parser().parse_args(
        ['--optimizer', 'adamw', '--param-dtype', 'float32',
         '--remat-policy', 'save_dots', '--batch', '2', '--seq', '512'])
    cfg, optimizer, batch, seq = bench.train_setup(args, 'bench-1b7', True)
    assert (optimizer, cfg.param_dtype, cfg.remat_policy, batch, seq) == \
        ('adamw', torch.float32, 'save_dots', 2, 512)


def test_without_a_card_it_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for mode in ('train', 'decode', 'kernels'):
        assert bench.main(['--mode', mode]) == 1
        line = json.loads(capsys.readouterr().out)
        assert line['metric'] == 'train_mfu_unavailable'
        assert set(line) == TOP_KEYS and line['value'] == 0


@pytest.mark.parametrize('name,peak,estimated', [
    ('NVIDIA H100 80GB HBM3', 989.0, False),
    ('NVIDIA H100 PCIe', 756.0, False),
    ('NVIDIA H100 SXM5 80GB', 989.0, False),
    ('NVIDIA A100-SXM4-80GB', 989.0, True),
    ('NVIDIA H100 NVL', 989.0, True)])
def test_peak_from_the_card_name(monkeypatch, name, peak, estimated):
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda *_: name)
    assert bench.peak_tflops(torch.device('cuda')) == (peak, estimated)
    assert bench.peak_tflops(torch.device('cpu')) == (0.1, False)
