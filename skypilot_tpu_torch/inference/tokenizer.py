"""Tokenizers behind one encode/decode interface.

The port's copy of ``ByteTokenizer``, ``render_transcript`` and
``get_tokenizer`` from ``skypilot_tpu/inference/tokenizer.py``: a
self-contained byte-level tokenizer, reversible for any UTF-8 text,
whose chat template is the plain role-prefixed transcript. The HF
``tokenizer.json`` path (and a checkpoint's own chat template) comes
with the HF weights bridge in a later slice; asking for a checkpoint's
tokenizer raises.
"""
from __future__ import annotations

from typing import List, Optional

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


def get_tokenizer(checkpoint_dir: Optional[str] = None) -> ByteTokenizer:
    """The byte-level tokenizer; a checkpoint's own tokenizer is not
    ported yet."""
    if checkpoint_dir:
        raise NotImplementedError(
            'HF checkpoint tokenizers are not ported yet '
            '(ROADMAP.md, queue A item 11)')
    return ByteTokenizer()
