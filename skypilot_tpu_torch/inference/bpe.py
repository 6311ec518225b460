"""A reader of HF ``tokenizer.json`` files: byte-level and SentencePiece-
style BPE, written here because the port runs where the ``tokenizers``
library is not installed.

It supports exactly the components that the checkpoints
``models/hf_interop.py`` imports ship, and encodes and decodes as
``tokenizers`` does (``encode(text, add_special_tokens=False)``,
``decode(ids, skip_special_tokens)``):

* Llama 3: ``Sequence[Split(Regex, Isolated), ByteLevel(use_regex=
  false)]`` pre-tokenizer, ``BPE`` with ``ignore_merges``, ``ByteLevel``
  decoder.
* GPT-2-style byte level: ``ByteLevel(add_prefix_space, use_regex=
  true)`` pre-tokenizer and decoder.
* Llama 2 / Mistral / Mixtral: ``Sequence[Prepend, Replace]``
  normalizer or a ``Metaspace`` pre-tokenizer, ``BPE`` with
  ``byte_fallback``, ``fuse_unk`` and ``unk_token``, and a
  ``Sequence[Replace, ByteFallback, Fuse, Strip]`` or ``Metaspace``
  decoder.

Added tokens are split out of the text first (longest match at the
leftmost position), those marked ``normalized`` after normalization, as
``tokenizers`` does even when it adds no special tokens: chat templates
emit ``<|start_header_id|>`` and the like as text. The post-processor
only adds special tokens, which this reader never does, so it is not
read. Any other component, option or regex construct raises
``ValueError`` naming it, rather than encode differently.

The split regexes use ``\\p{L}`` and ``\\p{N}``, which Python's ``re``
does not have; they are translated into classes built from
``unicodedata``'s general categories (L = Lu Ll Lt Lm Lo, N = Nd Nl No:
``²`` and ``Ⅻ`` are numbers, not letters), and ``\\s`` into Oniguruma's
whitespace (``\\t\\n\\v\\f\\r``, U+0085 and the Z categories, which
leaves out U+001C..U+001F that Python's ``\\s`` has).
"""
from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# A piece of text on its way through the pipeline: (text, starts at the
# beginning of the input).
Piece = Tuple[str, bool]


# ---------------------------------------------------------------------------
# Regex translation
# ---------------------------------------------------------------------------

def _class_body(points: List[int]) -> str:
    """A character-class body of sorted code points, as ranges."""
    out = []
    i = 0
    while i < len(points):
        j = i
        while j + 1 < len(points) and points[j + 1] == points[j] + 1:
            j += 1
        a, b = points[i], points[j]
        out.append(f'\\U{a:08x}' if a == b else f'\\U{a:08x}-\\U{b:08x}')
        i = j + 1
    return ''.join(out)


@functools.cache
def _class_bodies() -> Dict[str, str]:
    """\\p{L}, \\p{N} and \\s as class bodies (built once, on first
    use: a pass over every code point)."""
    space = set(map(ord, '\t\n\x0b\x0c\r\x85'))
    points: Dict[str, List[int]] = {'L': [], 'N': [], 's': []}
    for cp in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(cp))
        if cat[0] in 'LN':
            points[cat[0]].append(cp)
        elif cp in space or cat in ('Zs', 'Zl', 'Zp'):
            points['s'].append(cp)
    return {k: _class_body(v) for k, v in points.items()}


_PLAIN_ESCAPES = set('rntfv')


@functools.lru_cache(maxsize=16)
def translate_regex(pattern: str) -> 're.Pattern[str]':
    """Compile an Oniguruma pattern of a tokenizer.json split with
    Python's ``re``: ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` become
    explicit classes; any other letter escape raises."""
    bodies = _class_bodies()
    out = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == '\\' and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e == 'p':
                m = re.match(r'\{(\w+)\}', pattern[i + 2:])
                if m is None or m.group(1) not in ('L', 'N'):
                    raise ValueError(f'unsupported regex class in '
                                     f'{pattern!r} at {i}')
                body = bodies[m.group(1)]
                out.append(body if in_class else f'[{body}]')
                i += 2 + m.end()
                continue
            if e == 's':
                out.append(bodies['s'] if in_class else f'[{bodies["s"]}]')
            elif e == 'S' and not in_class:
                out.append(f'[^{bodies["s"]}]')
            elif e.isalnum() and e not in _PLAIN_ESCAPES:
                raise ValueError(f'unsupported regex escape \\{e} in '
                                 f'{pattern!r}')
            else:
                out.append(c + e)
            i += 2
            continue
        if c == '[' and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == '^':
                out.append('^')
                i += 1
        elif c == ']' and in_class:
            in_class = False
            out.append(c)
        elif c == '[' and in_class:
            raise ValueError(f'nested regex class in {pattern!r}')
        else:
            out.append(c)
        i += 1
    return re.compile(''.join(out))


# ---------------------------------------------------------------------------
# Byte-level alphabet
# ---------------------------------------------------------------------------

@functools.cache
def _byte_to_char() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('¡'), ord('¬') + 1)) +
          list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.cache
def _char_to_byte() -> Dict[str, int]:
    return {c: b for b, c in _byte_to_char().items()}


_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                 r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _split_isolated(text: str, regex: 're.Pattern[str]') -> List[str]:
    """Every match and every gap between matches, in order."""
    out = []
    last = 0
    for m in regex.finditer(text):
        if m.start() > last:
            out.append(text[last:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        last = m.end()
    if last < len(text):
        out.append(text[last:])
    return out


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

def _check_keys(spec: dict, allowed: Sequence[str], what: str) -> None:
    extra = set(spec) - set(allowed) - {'type'}
    if extra:
        raise ValueError(f'unsupported {what} fields {sorted(extra)}')


def _replace_pattern(spec: dict) -> Callable[[str], str]:
    pattern, content = spec['pattern'], spec['content']
    if 'String' in pattern:
        s = pattern['String']
        return lambda text: text.replace(s, content)
    if 'Regex' in pattern:
        regex = translate_regex(pattern['Regex'])
        return lambda text: regex.sub(lambda _: content, text)
    raise ValueError(f'unsupported Replace pattern {pattern!r}')


def build_normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    kind = spec.get('type')
    if kind == 'Sequence':
        steps = [build_normalizer(s) for s in spec['normalizers']]

        def run(text):
            for step in steps:
                text = step(text)
            return text
        return run
    if kind == 'Prepend':
        prefix = spec['prepend']
        return lambda text: prefix + text if text else text
    if kind == 'Replace':
        return _replace_pattern(spec)
    raise ValueError(f'unsupported tokenizer.json normalizer {kind!r}')


PreTokenizer = Callable[[List[Piece]], List[Piece]]


def build_pre_tokenizer(spec: Optional[dict]) -> PreTokenizer:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get('type')
    if kind == 'Sequence':
        steps = [build_pre_tokenizer(s) for s in spec['pretokenizers']]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == 'Split':
        _check_keys(spec, ('pattern', 'behavior', 'invert'), 'Split')
        if spec.get('behavior') != 'Isolated' or spec.get('invert'):
            raise ValueError(
                f"unsupported Split behavior {spec.get('behavior')!r} "
                f"(invert={spec.get('invert')!r}); only Isolated")
        pattern = spec['pattern']
        if 'Regex' in pattern:
            regex = translate_regex(pattern['Regex'])
        else:
            regex = re.compile(re.escape(pattern['String']))

        def split(pieces):
            out = []
            for text, first in pieces:
                parts = _split_isolated(text, regex)
                out.extend((p, first and i == 0)
                           for i, p in enumerate(parts))
            return out
        return split
    if kind == 'ByteLevel':
        _check_keys(spec, ('add_prefix_space', 'trim_offsets',
                           'use_regex'), 'ByteLevel')
        prefix = bool(spec.get('add_prefix_space'))
        regex = (translate_regex(_GPT2_PATTERN)
                 if spec.get('use_regex', True) else None)
        table = _byte_to_char()

        def byte_level(pieces):
            out = []
            for text, first in pieces:
                if prefix and not text.startswith(' '):
                    text = ' ' + text
                parts = [text] if regex is None else \
                    _split_isolated(text, regex)
                out.extend((''.join(table[b] for b in p.encode('utf-8')),
                            first and i == 0)
                           for i, p in enumerate(parts))
            return out
        return byte_level
    if kind == 'Metaspace':
        _check_keys(spec, ('replacement', 'prepend_scheme', 'split',
                           'add_prefix_space', 'str_rep'), 'Metaspace')
        rep = spec['replacement']
        scheme = spec.get('prepend_scheme') or (
            'always' if spec.get('add_prefix_space', True) else 'never')
        if scheme not in ('always', 'first', 'never'):
            raise ValueError(f'unsupported Metaspace prepend_scheme '
                             f'{scheme!r}')
        do_split = spec.get('split', True)

        def metaspace(pieces):
            out = []
            for text, first in pieces:
                text = text.replace(' ', rep)
                if not text.startswith(rep) and (
                        scheme == 'always' or (scheme == 'first' and first)):
                    text = rep + text
                if not do_split:
                    out.append((text, first))
                    continue
                # Split before every replacement character (each one
                # starts the piece that follows it).
                starts = [0] + [i for i, c in enumerate(text)
                                if c == rep and i > 0]
                for j, s in enumerate(starts):
                    end = starts[j + 1] if j + 1 < len(starts) else len(text)
                    if end > s:
                        out.append((text[s:end], first and j == 0))
            return out
        return metaspace
    raise ValueError(f'unsupported tokenizer.json pre_tokenizer {kind!r}')


Decoder = Callable[[List[str]], List[str]]


def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode('utf-8'))
            except UnicodeDecodeError:
                out.extend('�' * len(pending))
            pending.clear()

    for tok in tokens:
        if len(tok) == 6 and tok.startswith('<0x') and tok.endswith('>'):
            try:
                pending.append(int(tok[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(tok)
    flush()
    return out


def _strip(content: str, start: int, stop: int) -> Decoder:
    def run(tokens):
        out = []
        for tok in tokens:
            a = 0
            for i, c in enumerate(tok[:start]):
                if c != content:
                    break
                a = i + 1
            b = len(tok)
            for i in range(min(stop, len(tok))):
                if tok[len(tok) - i - 1] != content:
                    break
                b = len(tok) - i - 1
            out.append(tok[a:max(a, b)])
        return out
    return run


def build_decoder(spec: Optional[dict]) -> Optional[Decoder]:
    if spec is None:
        return None
    kind = spec.get('type')
    if kind == 'Sequence':
        steps = [build_decoder(s) for s in spec['decoders']]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == 'ByteLevel':
        table = _char_to_byte()

        def byte_level(tokens):
            data = bytearray()
            for tok in tokens:
                if all(c in table for c in tok):
                    data.extend(table[c] for c in tok)
                else:
                    data.extend(tok.encode('utf-8'))
            return [data.decode('utf-8', errors='replace')]
        return byte_level
    if kind == 'Replace':
        replace = _replace_pattern(spec)
        return lambda tokens: [replace(t) for t in tokens]
    if kind == 'ByteFallback':
        return _byte_fallback
    if kind == 'Fuse':
        return lambda tokens: [''.join(tokens)]
    if kind == 'Strip':
        return _strip(spec['content'], int(spec['start']),
                      int(spec['stop']))
    if kind == 'Metaspace':
        rep = spec['replacement']
        scheme = spec.get('prepend_scheme') or (
            'always' if spec.get('add_prefix_space', True) else 'never')

        def metaspace(tokens):
            # In the first token every replacement character goes
            # (unless nothing was prepended), elsewhere each is a space.
            return [''.join('' if c == rep and i == 0 and scheme != 'never'
                            else ' ' if c == rep else c for c in tok)
                    for i, tok in enumerate(tokens)]
        return metaspace
    raise ValueError(f'unsupported tokenizer.json decoder {kind!r}')


class BPEModel:
    """The ``BPE`` model of tokenizer.json: merges by rank (lowest rank,
    then leftmost pair first), ``ignore_merges``, ``byte_fallback`` to
    ``<0xXX>`` tokens, ``unk_token`` with ``fuse_unk``."""

    def __init__(self, spec: dict) -> None:
        if spec.get('type', 'BPE') != 'BPE':
            raise ValueError(f"unsupported tokenizer.json model "
                             f"{spec.get('type')!r}")
        _check_keys(spec, ('dropout', 'unk_token',
                           'continuing_subword_prefix',
                           'end_of_word_suffix', 'fuse_unk',
                           'byte_fallback', 'ignore_merges', 'vocab',
                           'merges'), 'BPE')
        for key in ('continuing_subword_prefix', 'end_of_word_suffix'):
            if spec.get(key):
                raise ValueError(f'unsupported BPE option {key}='
                                 f'{spec[key]!r}')
        if spec.get('dropout'):
            raise ValueError(f"unsupported BPE dropout {spec['dropout']!r}")
        self.vocab: Dict[str, int] = dict(spec['vocab'])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get('unk_token')
        self.fuse_unk = bool(spec.get('fuse_unk'))
        self.byte_fallback = bool(spec.get('byte_fallback'))
        self.ignore_merges = bool(spec.get('ignore_merges'))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(spec['merges']):
            a, b = merge.split(' ', 1) if isinstance(merge, str) else merge
            try:
                pair = (self.vocab[a], self.vocab[b])
                self.merges[pair] = (rank, self.vocab[a + b])
            except KeyError:
                raise ValueError(f'merge {a!r} {b!r} names a token that is '
                                 'not in the vocab') from None
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk: Optional[int] = None   # a pending unk not yet emitted
        for ch in word:
            if ch in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[ch])
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f'<0x{b:02X}>')
                         for b in ch.encode('utf-8')]
                if None not in codes:
                    ids.extend(codes)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f'unk_token {self.unk_token!r} is not '
                                     'in the vocab')
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, ids: List[int]) -> List[int]:
        n = len(ids)
        sym = list(ids)
        alive = [True] * n
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue   # an expired entry
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self.merges.get((sym[prev[pos]], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((sym[pos], sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is None:
            hit = self._merge_all(self._symbols(word))
            if len(self._cache) < 65536:
                self._cache[word] = hit
        return list(hit)


class Tokenizer:
    """A tokenizer.json pipeline: added tokens, normalizer,
    pre-tokenizer, BPE model and decoder, with the ``tokenizers``
    library's ``Tokenizer`` methods that ``HFTokenizer`` calls."""

    def __init__(self, spec: dict) -> None:
        for key in ('truncation', 'padding'):
            if spec.get(key) is not None:
                raise ValueError(f'unsupported tokenizer.json {key} '
                                 f'{spec[key]!r}')
        self.model = BPEModel(spec['model'])
        self._normalize = build_normalizer(spec.get('normalizer'))
        self._pre_tokenize = build_pre_tokenizer(spec.get('pre_tokenizer'))
        self._decoder = build_decoder(spec.get('decoder'))
        self.added: Dict[str, int] = {}
        self.added_ids: Dict[int, str] = {}
        self.special = set()
        raw, normalized = [], []
        for tok in spec.get('added_tokens') or []:
            for flag in ('single_word', 'lstrip', 'rstrip'):
                if tok.get(flag):
                    raise ValueError(f'unsupported added-token option '
                                     f'{flag} on {tok["content"]!r}')
            self.added[tok['content']] = tok['id']
            self.added_ids[tok['id']] = tok['content']
            if tok.get('special'):
                self.special.add(tok['content'])
            (normalized if tok.get('normalized') else raw).append(
                tok['content'])
        self._raw_split = self._added_regex(raw)
        self._normalized_split = self._added_regex(normalized)

    @classmethod
    def from_file(cls, path: str) -> 'Tokenizer':
        with open(path, encoding='utf-8') as f:
            return cls(json.load(f))

    @staticmethod
    def _added_regex(contents: List[str]) -> Optional['re.Pattern[str]']:
        if not contents:
            return None
        # Longest first: at one position the longest token wins.
        alts = sorted(set(contents), key=lambda s: (-len(s), s))
        return re.compile('|'.join(re.escape(s) for s in alts))

    def _split_added(self, text: str, regex, first: bool):
        """[(added token id, None) or (None, (text, first))] in order."""
        if regex is None:
            return [(None, (text, first))] if text else []
        out = []
        last = 0
        for m in regex.finditer(text):
            if m.start() > last:
                out.append((None, (text[last:m.start()],
                                   first and last == 0)))
            out.append((self.added[m.group()], None))
            last = m.end()
        if last < len(text):
            out.append((None, (text[last:], first and last == 0)))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of ``text`` (no special tokens added)."""
        ids: List[int] = []
        for added, piece in self._split_added(text, self._raw_split, True):
            if added is not None:
                ids.append(added)
                continue
            normalized = self._normalize(piece[0])
            for added2, sub in self._split_added(
                    normalized, self._normalized_split, piece[1]):
                if added2 is not None:
                    ids.append(added2)
                    continue
                for word, _ in self._pre_tokenize([sub]):
                    ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        if self._decoder is None:
            return ' '.join(tokens)
        return ''.join(self._decoder(tokens))

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.model.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        if i in self.added_ids:
            return self.added_ids[i]
        return self.model.id_to_token.get(i)

    def get_vocab_size(self) -> int:
        """Distinct tokens of the model's vocab and the added tokens."""
        return len(set(self.model.vocab) | set(self.added))
