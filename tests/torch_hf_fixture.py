"""HF checkpoint directories for the port's parity tests.

``numpy_params`` draws a JAX params tree from seeded numpy (norm scales
included); ``write_checkpoint`` writes it with the JAX package's own
``hf_interop.save_checkpoint`` and, with ``tokenizer=True``, copies in
the committed Llama-3-pipeline tokenizer fixture
(``skypilot_tpu_torch/testdata/tokenizer_llama3``, 1005 tokens: the
models that use it are TINY with ``vocab_size`` 1024).
"""
import os
import shutil

import jax
import numpy as np

from skypilot_tpu.models import hf_interop as jhf
from skypilot_tpu.models import llama as jllama

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER_FIXTURE = os.path.join(REPO_ROOT, 'skypilot_tpu_torch',
                                 'testdata', 'tokenizer_llama3')


def numpy_params(cfg, seed=0):
    """The JAX params tree of ``cfg`` with every leaf drawn from seeded
    numpy, as fp32 numpy arrays."""
    shapes = jax.eval_shape(lambda: jllama.init_params(jax.random.key(0),
                                                       cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def write_checkpoint(path, cfg, *, seed=0, file_dtype=None,
                     tokenizer=False):
    jhf.save_checkpoint(numpy_params(cfg, seed), cfg, str(path),
                        dtype=file_dtype)
    if tokenizer:
        for name in ('tokenizer.json', 'tokenizer_config.json'):
            shutil.copy(os.path.join(TOKENIZER_FIXTURE, name),
                        os.path.join(str(path), name))
    return str(path)
