"""The port's tokenizer.json reader against the ``tokenizers`` library and
the JAX package's ``HFTokenizer``, on the CPU.

Five pipelines are built and trained here with ``tokenizers`` on a
corpus written in this file: Llama 3's (regex split, byte level,
``ignore_merges``, specials added after the vocab), GPT-2's byte level
with ``add_prefix_space``, and Llama 2's SentencePiece-style BPE
(``byte_fallback``, ``fuse_unk``, ``<unk>``) in its legacy form
(``Prepend``/``Replace`` normalizer, ``Replace``/``ByteFallback``/
``Fuse``/``Strip`` decoder) and with ``Metaspace`` pre-tokenizer and
decoder (prepended to the first piece and unsplit, or to every piece
and split at each ``▁``). On each, the port's ``HFTokenizer`` must give
the JAX one's ids, decoded strings (specials stripped) and raw
``tokenizers`` decode (specials kept) on probe strings that cover
ASCII, digit runs, ``²`` and ``Ⅻ``, combining accents, CJK, emoji,
``\\r\\n`` and space runs, added-token strings inside text and
characters outside the vocab; chat renderings and bos/eos/pad ids must
agree; unsupported components must raise. The committed fixture
``skypilot_tpu_torch/testdata/tokenizer_llama3`` must regenerate
identically from ``make_fixture`` here, and its ``expected.json`` must
hold.

Run this file as a script to rewrite the fixture::

    PYTHONPATH=. python tests/test_torch_tokenizer.py
"""
import json
import os
import sys

import numpy as np
import pytest

from skypilot_tpu.inference import tokenizer as jtokenizer
from skypilot_tpu_torch.inference import bpe
from skypilot_tpu_torch.inference import tokenizer as ttokenizer
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

tokenizers = pytest.importorskip('tokenizers')
from tokenizers import (AddedToken, Regex, Tokenizer, decoders,  # noqa: E402
                        models, normalizers, pre_tokenizers, processors)
from tokenizers.trainers import BpeTrainer  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO_ROOT, 'skypilot_tpu_torch', 'testdata',
                       'tokenizer_llama3')

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                  r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                  r"\s+(?!\S)|\s+")
LLAMA3_SPECIALS = ['<|begin_of_text|>', '<|end_of_text|>',
                   '<|start_header_id|>', '<|end_header_id|>',
                   '<|eot_id|>']
# A Llama-3-style chat template, written for the fixture.
LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] not in ['system', 'user', 'assistant'] %}"
    "{{ raise_exception('unknown role ' + message['role']) }}{% endif %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    " + message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")

_WORDS = ('the a of to and in is that it for on with as was at by this '
          'model token serve train request batch cache page block kernel '
          'layer head query key value attention weight decode prefill '
          'user assistant system hello world quick brown fox jumps over '
          'lazy dog résumé naïve café über straße 東京 数据 模型 😀 🚀 '
          "it's we're they've I'm you'll he'd DON'T 42 2048 3.14 1,000 "
          '(x) [y] {z} <tag> a+b=c #1 @home 100% $5 -- ... !? \t').split()


_SYLLABLES = ('ka ri to mu ne sa lo vi en ar ing ter pre con str ph qu '
              'zy bl ou ea ch th sh gr ion ent ly er').split()


def corpus(n_lines=400, seed=0):
    """The training text: lines of words and made-up words (two to four
    syllables) drawn by a seeded numpy RNG, with digit runs,
    punctuation and line breaks mixed in."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_lines):
        words = list(rng.choice(_WORDS, size=int(rng.integers(4, 16))))
        words += [''.join(rng.choice(_SYLLABLES,
                                     size=int(rng.integers(2, 5))))
                  for _ in range(int(rng.integers(1, 5)))]
        rng.shuffle(words)
        line = ' '.join(words)
        if i % 7 == 0:
            line += f' {int(rng.integers(0, 10 ** 6))}'
        if i % 11 == 0:
            line += '\r\n  indented'
        lines.append(line)
    return lines


PROBES = [
    'Hello world', ' leading space', 'trailing space ', '',
    'digits 1234567890 and 3.14159 and 0007', '²³ Ⅻ Ⅳ ½ ①',
    'café naïve résumé', 'é combining ä ộ',
    '你好，世界。漢字かなカナ', '😀 🚀👍🏽 emoji 🏳️‍🌈',
    'line one\r\nline two\n\nline three\r\n\r\n', 'spaces   inside\t\ttabs',
    "it's we're I'LL they'VE DON'T", 'MiXeD CaSe ABC xyz',
    '<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>',
    'text<|eot_id|>more<|begin_of_text|><|begin_of_text|>',
    '<|notatoken|> <|eot_id <s>hi</s> <unk>', '   ', 'a',
    'x\x1cy z w　v', 'def f(x): return x**2  # ok',
    'Ǆ ǅ ǆ titlecase ſ K', 'ℌ𝔢𝔩𝔩𝔬 𝟙𝟚𝟛 math',
]


# ---------------------------------------------------------------------------
# Pipelines, built with ``tokenizers``
# ---------------------------------------------------------------------------

def _llama3_tokenizer(vocab_size, lines):
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior='isolated',
                             invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True,
                                 use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(lines, BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    # Llama 3's specials follow the vocab as added tokens.
    tok.add_special_tokens(LLAMA3_SPECIALS)
    bos = tok.token_to_id('<|begin_of_text|>')
    tok.post_processor = processors.TemplateProcessing(
        single='<|begin_of_text|> $A', special_tokens=[
            ('<|begin_of_text|>', bos)])
    return tok


def _gpt2_tokenizer(lines):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(lines, BpeTrainer(
        vocab_size=500, show_progress=False,
        special_tokens=['<|begin_of_text|>', '<|end_of_text|>'],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_tokens([AddedToken('brown fox', normalized=True),
                    AddedToken('Ǆé', normalized=False)])
    return tok


def _llama2_tokenizer(lines, metaspace, scheme='first', split=False):
    """SentencePiece-style BPE: <unk> <s> </s>, then the 256 byte
    tokens in the model's vocab (as Llama 2's), then the merges."""
    tok = Tokenizer(models.BPE(unk_token='<unk>', fuse_unk=True,
                               byte_fallback=True))
    if metaspace:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement='▁', prepend_scheme=scheme, split=split)
        tok.decoder = decoders.Metaspace(replacement='▁',
                                         prepend_scheme=scheme,
                                         split=split)
    else:
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend('▁'), normalizers.Replace(' ', '▁')])
        tok.decoder = decoders.Sequence([
            decoders.Replace('▁', ' '), decoders.ByteFallback(),
            decoders.Fuse(), decoders.Strip(' ', 1, 0)])
    tok.train_from_iterator(lines, BpeTrainer(
        vocab_size=600, show_progress=False, limit_alphabet=60,
        special_tokens=['<unk>', '<s>', '</s>']))
    spec = json.loads(tok.to_str())
    vocab = spec['model']['vocab']
    rest = sorted((i, t) for t, i in vocab.items() if i >= 3)
    new = {'<unk>': 0, '<s>': 1, '</s>': 2}
    new.update({f'<0x{b:02X}>': 3 + b for b in range(256)})
    for _, t in rest:
        new.setdefault(t, len(new))
    spec['model']['vocab'] = new
    return Tokenizer.from_str(json.dumps(spec))


def _save(tok, directory, config):
    os.makedirs(directory, exist_ok=True)
    tok.save(os.path.join(directory, 'tokenizer.json'))
    with open(os.path.join(directory, 'tokenizer_config.json'), 'w') as f:
        json.dump(config, f, indent=1)
    return directory


PIPELINES = {
    'llama3': lambda d: _save(
        _llama3_tokenizer(700, corpus()), d,
        {'bos_token': '<|begin_of_text|>', 'eos_token': '<|eot_id|>',
         'chat_template': LLAMA3_TEMPLATE}),
    'gpt2': lambda d: _save(
        _gpt2_tokenizer(corpus(200, seed=1)), d,
        {'bos_token': '<|begin_of_text|>', 'eos_token': '<|end_of_text|>'}),
    'llama2': lambda d: _save(
        _llama2_tokenizer(corpus(200, seed=2), metaspace=False), d,
        {'bos_token': {'content': '<s>'}, 'eos_token': '</s>',
         'chat_template': [{'name': 'default', 'template':
                            "{{ bos_token }}{% for m in messages %}[{{ "
                            "m['role'] }}] {{ m['content'] }} {% endfor %}"
                            "{% if add_generation_prompt %}[assistant]"
                            "{% endif %}"}]}),
    'llama2-metaspace': lambda d: _save(
        _llama2_tokenizer(corpus(200, seed=3), metaspace=True), d,
        {'eos_token': '</s>'}),
    'metaspace-split': lambda d: _save(
        _llama2_tokenizer(corpus(200, seed=4), metaspace=True,
                          scheme='always', split=True), d,
        {'eos_token': '</s>'}),
}


@pytest.fixture(scope='module', params=list(PIPELINES))
def pipeline(request, tmp_path_factory):
    return PIPELINES[request.param](
        str(tmp_path_factory.mktemp(request.param)))


def _random_texts(n, seed):
    """Strings of characters drawn from the probes, the corpus and a few
    Unicode blocks, in random runs."""
    rng = np.random.default_rng(seed)
    alphabet = sorted(set(''.join(PROBES) + ''.join(_WORDS) + ' \n\r\t' +
                          ''.join(chr(c) for c in range(0x370, 0x3A0))))
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 40))
        out.append(''.join(rng.choice(alphabet, size=k)))
    return out


def test_ids_and_text_match_jax_and_tokenizers(pipeline):
    jtok = jtokenizer.HFTokenizer(pipeline)
    ttok = ttokenizer.HFTokenizer(pipeline)
    assert (ttok.vocab_size, ttok.bos_id, ttok.eos_id, ttok.pad_id) == \
        (jtok.vocab_size, jtok.bos_id, jtok.eos_id, jtok.pad_id)
    for text in PROBES + _random_texts(150, seed=4):
        for add_bos in (True, False):
            ids = ttok.encode(text, add_bos=add_bos)
            assert ids == jtok.encode(text, add_bos=add_bos), text
        assert ttok.decode(ids) == jtok.decode(ids), text
        assert ttok._tok.decode(ids) == jtok._tok.decode(
            ids, skip_special_tokens=False), text


def test_id_lookups_match(pipeline):
    raw = Tokenizer.from_file(os.path.join(pipeline, 'tokenizer.json'))
    ours = bpe.Tokenizer.from_file(os.path.join(pipeline, 'tokenizer.json'))
    assert ours.get_vocab_size() == raw.get_vocab_size()
    for i in range(raw.get_vocab_size() + 2):
        tok = raw.id_to_token(i)
        assert ours.id_to_token(i) == tok
        if tok is not None:
            assert ours.token_to_id(tok) == raw.token_to_id(tok)
    assert ours.token_to_id('<|nope|>') is None
    # Random ids, out-of-vocab ids included (the model's vocab may be
    # larger than the tokenizer's).
    rng = np.random.default_rng(5)
    for _ in range(30):
        ids = rng.integers(0, raw.get_vocab_size() + 50, size=12).tolist()
        for skip in (True, False):
            assert ours.decode(ids, skip) == raw.decode(
                ids, skip_special_tokens=skip)


MESSAGES = [{'role': 'system', 'content': '  be brief '},
            {'role': 'user', 'content': 'hi there<|eot_id|>'}]


def test_chat_rendering_matches(pipeline):
    jtok = jtokenizer.HFTokenizer(pipeline)
    ttok = ttokenizer.HFTokenizer(pipeline)
    assert ttok.chat_template == jtok.chat_template
    for gen in (True, False):
        text = ttok.apply_chat_template(MESSAGES, add_generation_prompt=gen)
        assert text == jtok.apply_chat_template(
            MESSAGES, add_generation_prompt=gen)
        assert ttok.encode(text, add_bos=False) == jtok.encode(
            text, add_bos=False)
    if ttok.chat_template and 'raise_exception' in ttok.chat_template:
        for tok in (jtok, ttok):
            with pytest.raises(ValueError, match='chat template error'):
                tok.apply_chat_template([{'role': 'tool', 'content': 'x'}])


def _spec():
    with open(os.path.join(FIXTURE, 'tokenizer.json'),
              encoding='utf-8') as f:
        return json.load(f)


UNSUPPORTED = {
    'normalizer': lambda s: s.update(normalizer={'type': 'NFKC'}),
    'pre_tokenizer': lambda s: s.update(
        pre_tokenizer={'type': 'Whitespace'}),
    'split behavior': lambda s: s['pre_tokenizer']['pretokenizers'][0]
    .update(behavior='Removed'),
    'regex escape': lambda s: s['pre_tokenizer']['pretokenizers'][0]
    .update(pattern={'Regex': r'\w+'}),
    'unicode class': lambda s: s['pre_tokenizer']['pretokenizers'][0]
    .update(pattern={'Regex': r'\p{Lu}+'}),
    'decoder': lambda s: s.update(decoder={'type': 'WordPiece',
                                           'prefix': '##'}),
    'model': lambda s: s['model'].update(type='WordPiece'),
    'dropout': lambda s: s['model'].update(dropout=0.1),
    'subword prefix': lambda s: s['model'].update(
        continuing_subword_prefix='##'),
    'truncation': lambda s: s.update(truncation={'max_length': 8}),
    'added token flag': lambda s: s['added_tokens'][0].update(lstrip=True),
}


@pytest.mark.parametrize('case', list(UNSUPPORTED))
def test_unsupported_components_raise(case):
    spec = _spec()
    UNSUPPORTED[case](spec)
    with pytest.raises(ValueError, match='unsupported'):
        bpe.Tokenizer(spec)


def test_letter_and_number_classes_follow_unicode_categories():
    """\\p{L} and \\p{N} are general categories: ``²``, ``Ⅻ`` and ``①``
    are numbers (Python's ``\\d`` has none of them, ``[^\\W\\d_]``
    takes ``²`` for a letter)."""
    regex = bpe.translate_regex(r'\p{N}+|\p{L}+|\s+|.')
    assert regex.findall('x²Ⅻ①7y\x1c ') == [
        'x', '²Ⅻ①7', 'y', '\x1c', ' ']


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

def make_fixture(directory):
    """Write the Llama-3-pipeline fixture into ``directory``:
    tokenizer.json (vocab ~1000 with the five specials),
    tokenizer_config.json (bos, eos, chat template) and expected.json
    (``tokenizers``' ids of ``PROBES``)."""
    tok = _llama3_tokenizer(1000, corpus(600, seed=7))
    _save(tok, directory, {'bos_token': '<|begin_of_text|>',
                           'eos_token': '<|eot_id|>',
                           'chat_template': LLAMA3_TEMPLATE})
    expected = [{'text': t, 'ids': tok.encode(
        t, add_special_tokens=False).ids} for t in PROBES]
    with open(os.path.join(directory, 'expected.json'), 'w',
              encoding='utf-8') as f:
        json.dump(expected, f, indent=1, ensure_ascii=False)


def _load_all(directory):
    out = {}
    for name in ('tokenizer.json', 'tokenizer_config.json',
                 'expected.json'):
        with open(os.path.join(directory, name), encoding='utf-8') as f:
            out[name] = json.load(f)
    return out


def test_fixture_regenerates_identically(tmp_path):
    make_fixture(str(tmp_path))
    assert _load_all(str(tmp_path)) == _load_all(FIXTURE)
    assert 990 <= bpe.Tokenizer.from_file(
        os.path.join(FIXTURE, 'tokenizer.json')).get_vocab_size() <= 1010


def test_fixture_expected_ids_hold():
    tok = ttokenizer.HFTokenizer(FIXTURE)
    expected = _load_all(FIXTURE)['expected.json']
    assert len(expected) >= 20
    for case in expected:
        assert tok.encode(case['text'], add_bos=False) == case['ids']
        assert tok._tok.decode(case['ids']) == case['text']
    assert tok.eos_id == tok._tok.token_to_id('<|eot_id|>')
    assert tok.bos_id == tok._tok.token_to_id('<|begin_of_text|>')


def test_get_tokenizer_factory(tmp_path):
    assert isinstance(ttokenizer.get_tokenizer(FIXTURE),
                      ttokenizer.HFTokenizer)
    assert isinstance(ttokenizer.get_tokenizer(None),
                      ttokenizer.ByteTokenizer)
    assert isinstance(ttokenizer.get_tokenizer(str(tmp_path)),
                      ttokenizer.ByteTokenizer)
    with pytest.raises(ValueError, match='no tokenizer.json'):
        ttokenizer.get_tokenizer(str(tmp_path), require=True)
    (tmp_path / 'tokenizer.json').write_text(json.dumps(
        {'model': {'type': 'BPE', 'vocab': {'a': 0, 'b': 1, 'ab': 2},
                   'merges': [['a', 'b']]}}))
    assert bpe.Tokenizer.from_file(
        str(tmp_path / 'tokenizer.json')).encode('abba') == [2, 1, 0]
    with pytest.raises(ValueError, match='no eos token'):
        ttokenizer.HFTokenizer(str(tmp_path))


if __name__ == '__main__':
    make_fixture(FIXTURE)
    print('wrote', FIXTURE, file=sys.stderr)
