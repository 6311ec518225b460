"""Tokenizers behind one encode/decode interface: the port of
``skypilot_tpu/inference/tokenizer.py``.

* ``ByteTokenizer``: a self-contained byte-level fallback (no vocab
  files), reversible for any UTF-8 text; the tiny test models (vocab
  512) cover its full id range.
* ``HFTokenizer``: a checkpoint's own BPE from its ``tokenizer.json``
  and its chat template from ``tokenizer_config.json``. The reference
  reads the file with the ``tokenizers`` library; the port reads it
  with ``inference/bpe.py``, which gives the same ids and text.
* ``get_tokenizer(dir)``: HF when the dir has a tokenizer.json, byte-
  level otherwise. Engines only ever see ids.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from skypilot_tpu_torch.inference import bpe

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3


def render_transcript(messages,
                      add_generation_prompt: bool = True) -> str:
    """Plain role-prefixed chat transcript (the no-template fallback)."""
    text = ''.join(
        f"{m.get('role', 'user')}: {m.get('content', '')}\n"
        for m in messages)
    return text + ('assistant:' if add_generation_prompt else '')


class ByteTokenizer:
    vocab_size = 256 + _OFFSET
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    chat_template = None

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]:
        ids = [b + _OFFSET for b in text.encode('utf-8')]
        return [BOS_ID] + ids if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - _OFFSET for i in ids
                     if i >= _OFFSET and i - _OFFSET < 256)
        return data.decode('utf-8', errors='replace')

    def apply_chat_template(self, messages,
                            add_generation_prompt: bool = True) -> str:
        return render_transcript(messages, add_generation_prompt)


class HFTokenizer:
    """BPE tokenizer from an HF checkpoint dir (tokenizer.json).

    Special-token ids come from tokenizer_config.json (bos/eos token
    strings -> ids); pad defaults to eos the way HF generation does
    when no pad token is defined.
    """

    def __init__(self, path: str) -> None:
        tok_file = (path if path.endswith('.json')
                    else os.path.join(path, 'tokenizer.json'))
        self._tok = bpe.Tokenizer.from_file(tok_file)
        self.vocab_size = self._tok.get_vocab_size()
        base = os.path.dirname(tok_file)
        self.bos_id, self.eos_id = self._special_ids(base)
        self.pad_id = self.eos_id
        self.chat_template = self._load_chat_template(base)
        self._compiled_template = None
        if self.chat_template:
            # Compiled once, in jinja2's immutable sandboxed
            # environment: the template ships with a third-party
            # checkpoint, and plain jinja would let it reach
            # __globals__/os.
            import jinja2
            from jinja2.sandbox import ImmutableSandboxedEnvironment
            env = ImmutableSandboxedEnvironment(
                trim_blocks=True, lstrip_blocks=True,
                undefined=jinja2.ChainableUndefined)
            env.globals['raise_exception'] = _template_raise
            self._compiled_template = env.from_string(self.chat_template)

    @staticmethod
    def _load_chat_template(base: str):
        cfg_file = os.path.join(base, 'tokenizer_config.json')
        if not os.path.exists(cfg_file):
            return None
        with open(cfg_file) as f:
            template = json.load(f).get('chat_template')
        if isinstance(template, list):
            # HF also allows [{name, template}, ...]; 'default' wins.
            by_name = {t.get('name'): t.get('template')
                       for t in template if isinstance(t, dict)}
            return by_name.get('default') or next(
                iter(by_name.values()), None)
        return template

    def apply_chat_template(self, messages,
                            add_generation_prompt: bool = True) -> str:
        """Render messages with the checkpoint's own chat template,
        falling back to a plain role-prefixed transcript. Templated
        prompts carry their own BOS: encode them with ``add_bos=False``.
        """
        if self._compiled_template is not None:
            bos = self._tok.id_to_token(self.bos_id) or ''
            eos = self._tok.id_to_token(self.eos_id) or ''
            return self._compiled_template.render(
                messages=messages,
                add_generation_prompt=add_generation_prompt,
                bos_token=bos, eos_token=eos)
        return render_transcript(messages, add_generation_prompt)

    def _special_ids(self, base: str):
        def token_str(v):
            return v['content'] if isinstance(v, dict) else v

        bos = eos = None
        cfg_file = os.path.join(base, 'tokenizer_config.json')
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                tc = json.load(f)
            if tc.get('bos_token'):
                bos = self._tok.token_to_id(token_str(tc['bos_token']))
            if tc.get('eos_token'):
                eos = self._tok.token_to_id(token_str(tc['eos_token']))
        if bos is None:
            for cand in ('<|begin_of_text|>', '<s>', '<bos>'):
                bos = self._tok.token_to_id(cand)
                if bos is not None:
                    break
        if eos is None:
            for cand in ('<|end_of_text|>', '</s>', '<eos>',
                         '<|eot_id|>'):
                eos = self._tok.token_to_id(cand)
                if eos is not None:
                    break
        if eos is None:
            raise ValueError(
                f'no eos token found for tokenizer under {base}: add a '
                'tokenizer_config.json with "eos_token" (an arbitrary '
                'vocab id must not silently become a stop token)')
        if bos is None:
            bos = eos
        return bos, eos

    def encode(self, text: str, *, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text)
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        specials = {self.bos_id, self.eos_id, self.pad_id}
        return self._tok.decode([i for i in ids if i not in specials],
                                skip_special_tokens=True)


def get_tokenizer(checkpoint_dir: Optional[str] = None, *,
                  require: bool = False):
    """HFTokenizer when the dir ships a tokenizer.json, else bytes.

    ``require=True`` (the engines' explicit ``hf_checkpoint`` path): a
    missing tokenizer.json raises instead of silently serving real
    weights through the byte fallback's vocabulary.
    """
    if checkpoint_dir and os.path.exists(
            os.path.join(checkpoint_dir, 'tokenizer.json')):
        return HFTokenizer(checkpoint_dir)
    if checkpoint_dir and require:
        raise ValueError(
            f'no tokenizer.json under {checkpoint_dir}: an HF '
            'checkpoint must ship its tokenizer (sentencepiece-only '
            'exports: convert with transformers '
            "`AutoTokenizer...save_pretrained`), or the byte fallback "
            'would silently mis-encode every prompt')
    return ByteTokenizer()


def _template_raise(message):  # chat templates call raise_exception()
    raise ValueError(f'chat template error: {message}')
