"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

``skypilot_tpu_torch`` (and ``chip_smoke.py``) must import with ``jax``
and ``skypilot_tpu`` blocked, their sources must not name either, nor
the libraries the card machine lacks (``tokenizers``, ``transformers``,
``safetensors``, ``ml_dtypes``, ``regex``: the port reads safetensors
and tokenizer.json files itself), and entry points must refuse to run
quietly on the CPU when no GPU is present.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO_ROOT, 'skypilot_tpu_torch')
CHIP_SMOKE = os.path.join(REPO_ROOT, 'chip_smoke.py')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'skypilot_tpu',
             'tokenizers', 'transformers', 'safetensors', 'ml_dtypes',
             'regex')


def _package_modules():
    mods = []
    for dirpath, dirnames, filenames in os.walk(PKG_DIR):
        dirnames[:] = [d for d in dirnames if d != '__pycache__']
        for name in sorted(filenames):
            if not name.endswith('.py'):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), REPO_ROOT)
            mod = rel[:-3].replace(os.sep, '.')
            if mod.endswith('.__init__'):
                mod = mod[:-len('.__init__')]
            mods.append((mod, os.path.join(dirpath, name)))
    return mods


def _forbidden_imports(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split('.')[0]
            if root in FORBIDDEN:
                bad.append(name)
    return bad


def test_every_module_imports_with_jax_blocked():
    mods = [m for m, _ in _package_modules()]
    for mod in ('ops.paged_attention', 'ops.flash_attention',
                'ops.attention', 'ops.decode_attention', 'train.loss',
                'train.step', 'train.pretrain', 'inference.engine',
                'batch.infer_worker', 'utils.env', 'inference.speculative',
                'models.lora', 'data.ckpt_manifest',
                'serve.adapter_registry', 'server.metrics',
                'utils.fault_injection', 'train.checkpoint', 'data.packer',
                'bench', 'models.hf_interop', 'inference.bpe',
                'train.finetune', 'inference.kv_migrate',
                'utils.resilience', 'data.fanout', 'train.grpo',
                'jobs.rl_pipeline', 'parallel.mesh', 'parallel.sharding',
                'parallel.launch', 'inference.sharding',
                'ops.collectives_bench', 'utils.tracing',
                'utils.trace_store', 'ops.ring_attention'):
        assert 'skypilot_tpu_torch.' + mod in mods
    code = (
        'import sys\n'
        f'for name in {FORBIDDEN!r}:\n'
        '    sys.modules[name] = None\n'
        'import importlib\n'
        f'for m in {mods!r}:\n'
        '    importlib.import_module(m)\n'
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok', len(" + repr(mods) + '))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


@pytest.mark.parametrize('path', [p for _, p in _package_modules()] +
                         [CHIP_SMOKE],
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_sources_name_no_jax_and_no_jax_package(path):
    assert _forbidden_imports(path) == []


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """Without a GPU, the entry points raise instead of running on the
    CPU; naming the CPU explicitly works."""
    from skypilot_tpu_torch.batch import infer_worker
    from skypilot_tpu_torch.inference import server
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ContinuousBatchingEngine('tiny')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        llama.init_params(0, get_model_config('tiny'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.main(['--model', 'tiny', '--port', '0'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        InferenceEngine('tiny')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.main(['--engine', 'batch', '--model', 'tiny', '--port', '0'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        server.main(['--engine', 'continuous', '--model', 'tiny',
                     '--port', '0'])
    src = tmp_path / 'in.jsonl'
    src.write_text('{"prompt": "hi"}\n')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        infer_worker.main(['--input', str(src), '--output',
                           str(tmp_path / 'out.jsonl')])
    from skypilot_tpu_torch import bench
    from skypilot_tpu_torch.train import finetune, pretrain, step
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pretrain.main(['--model', 'tiny', '--steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        finetune.main(['--hf-checkpoint', str(tmp_path), '--data',
                       str(src), '--steps', '1'])
    assert bench.main(['--mode', 'train']) == 1
    from skypilot_tpu_torch.jobs import rl_pipeline
    from skypilot_tpu_torch.train import grpo
    with pytest.raises(RuntimeError, match='no CUDA device'):
        grpo.main(['--model', 'tiny', '--steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        rl_pipeline.main(['--model', 'tiny', '--steps', '1', '--store',
                          str(tmp_path / 'store')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        step.create_train_state(0, get_model_config('tiny'),
                                step.TrainHParams())
    params = llama.init_params(0, get_model_config('tiny'), device='cpu')
    assert params['layers']['attn']['wq'].device.type == 'cpu'


def test_unported_engine_options_raise(tmp_path):
    """Under a mesh a tree with int8 experts raises with the reference's
    own limit, before any rank is needed (MoE configs with fp experts
    serve under a mesh: ``test_torch_tp_moe_serving.py``). LoRA pages,
    alone and beside a disaggregated role, are no longer refused: they
    get past the refusal and stop only for want of ranks, naming the
    launcher (they serve under a running mesh:
    ``test_torch_tp_lora.py``); ``role=`` and the checkpoint options
    are ported (an unknown role and a missing HF directory are errors
    of the input, not pointers to ROADMAP.md)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    for option in (dict(lora_pages=2), dict(role='prefill', lora_pages=2)):
        with pytest.raises(ValueError, match='parallel.launch'):
            ContinuousBatchingEngine('tiny', device='cpu', mesh='tensor=2',
                                     **option)
    engine = ContinuousBatchingEngine('tiny', device='cpu', max_slots=1,
                                      max_len=32, role='prefill')
    try:
        assert engine.role == 'prefill' and engine.exporter is not None
    finally:
        engine.shutdown()
    with pytest.raises(ValueError, match='SKYT_DISAGG_ROLE'):
        ContinuousBatchingEngine('tiny', device='cpu', role='both')
    from skypilot_tpu_torch.models import llama, quant
    from skypilot_tpu_torch.models.config import get_model_config
    int8_experts = quant.quantize_params(
        llama.init_params(0, get_model_config('tiny-moe'), device='cpu'),
        quantize_moe=True)
    for engine in (InferenceEngine, ContinuousBatchingEngine):
        with pytest.raises(NotImplementedError,
                           match='int8 MoE experts.*JAX reference'):
            engine('tiny-moe', device='cpu', mesh='tensor=2',
                   params=int8_experts)
    for engine in (InferenceEngine, ContinuousBatchingEngine):
        with pytest.raises(FileNotFoundError):
            engine('tiny', device='cpu',
                   hf_checkpoint=str(tmp_path / 'nonexistent'))


def test_spawned_ranks_serve_with_jax_blocked():
    """The ranks of a tensor-parallel launch import no JAX: with ``jax``
    and the JAX package blocked in each spawned rank, the continuous
    engine still serves under ``mesh='tensor=2'``, and the weights come
    from the port's own seeded init."""
    import numpy as np
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel.launch import launch
    import torch_tp_ranks as ranks
    params = llama.init_params(0, ranks.tiny_config(), device='cpu')

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return tree.numpy()

    out = launch(ranks.serve_cases, 2, to_numpy(params), ['continuous'],
                 True, device='cpu')
    for rank in (0, 1):
        assert out[rank]['jax_loaded'] is False
    tokens = out[0]['cases']['continuous']['tokens']
    assert [len(t) for t in tokens] == [ranks.N_NEW] * len(ranks.PROMPTS)
    assert all(0 <= t < 512 for row in tokens for t in row)
    assert np.asarray(tokens).dtype.kind == 'i'


def test_spawned_training_rank_takes_a_step_with_jax_blocked():
    """The ranks of a training mesh import no JAX: with ``jax`` and the
    JAX package blocked in each spawned rank, two ranks at ``fsdp=2``
    take a train step on the port's own seeded init."""
    import numpy as np
    from skypilot_tpu_torch.models import convert, llama
    from skypilot_tpu_torch.parallel.launch import launch
    import torch_train_ranks as train_ranks
    cfg = train_ranks.tiny_config()
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    run = {'name': 'step', 'hp': {'warmup_steps': 1, 'total_steps': 4},
           'params': convert.params_to_numpy(
               llama.init_params(0, cfg, device='cpu')),
           'batches': [{'tokens': tokens,
                        'targets': np.roll(tokens, -1, axis=1),
                        'weights': np.ones((4, 32), np.float32)}]}
    out = launch(train_ranks.mesh_checks, 2, 'fsdp=2', [run], None, True,
                 device='cpu')
    for rank in (0, 1):
        assert out[rank]['jax_loaded'] is False
        metrics = out[rank]['runs']['step']['metrics']
        assert len(metrics) == 1 and np.isfinite(metrics[0]['loss'])


def test_quantize_works_on_both_engines():
    """W8A8 (``quantize=True``) serves on the batch and the continuous
    engine (CPU): int8 layer weights, tokens in the vocab."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models.quant import QTensor
    batch = InferenceEngine('tiny', device='cpu', quantize=True)
    assert isinstance(batch.params['layers']['mlp']['wo'], QTensor)
    out = batch.generate_text(['hello'], max_new_tokens=4)
    assert len(out) == 1 and isinstance(out[0], str)
    cont = ContinuousBatchingEngine('tiny', device='cpu', max_slots=2,
                                    max_len=64, quantize=True)
    try:
        assert isinstance(cont.params['layers']['attn']['wq'], QTensor)
        ids = cont.generate_ids([5, 6, 7], max_new_tokens=4)
        assert len(ids) <= 4 and all(0 <= t < 512 for t in ids)
    finally:
        cont.shutdown()


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs a plain version: a CPU tensor
    handed to it raises (the dispatch, not the wrapper, picks the plain
    version for CPU tensors)."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    q = torch.zeros((1, 1, 1, 64))
    pool = torch.zeros((2, 16, 1, 64))
    with pytest.raises(ValueError, match='CUDA'):
        pa.paged_attention_kernel(
            q, pool, pool, torch.ones((1, 1), dtype=torch.int32),
            torch.ones((1,), dtype=torch.int32), 1)
    before = dict(pa.LAUNCHES)
    pa.paged_attention(q.reshape(1, 1, 1, 64), pool, pool,
                       torch.ones((1, 1), dtype=torch.int32),
                       torch.ones((1,), dtype=torch.int32))
    assert pa.LAUNCHES == before
